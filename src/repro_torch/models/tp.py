"""The tensor-parallel pieces of the program one rank of a process mesh
runs: the reference gives GSPMD its sharding rules (``models/sharding.py``)
and GSPMD writes each device's program; the port writes it here, over the
mesh of ``meshctx`` (a ``launch.mesh.ProcessMesh``, or a ``CountingMesh``
on ``meta``).

A parameter built under a mesh carries ``spec``, its live spec
(``sharding.localize``): a dim cut over "model" is tensor-parallel, a dim
cut over "data" is the ``fsdp`` shard, all-gathered just before the
product that reads it, as the reference's expert-parallel path gathers
its expert leaves. Without a mesh, or on a parameter with no ``spec``,
every function here is the plain single-process op.

* ``gather``: a weight whole on its fsdp dims;
* ``cols(w)``: whether ``w``'s output dim is cut over "model" (a
  column-parallel product); ``rows(w)``: its input dim (row-parallel);
* ``row_out``: a row-parallel product and its one all-reduce over
  "model", in the activation's dtype; or, with ``scatter_seq``, its
  reduce-scatter along the sequence (the sequence-parallel residual);
* ``seq_block`` and ``seq_gather``: a rank's block of the sequence over
  "model", and the blocks all-gathered whole (the sequence-parallel
  residual of every block type, ``models/blocks.py``);
* ``model_block``: a replicated leaf's slice for this rank's block of a
  width cut over "model" (the mamba2 mixer's per-head and per-channel
  leaves, the RG-LRU's gate biases), as a view of the whole leaf;
* ``mean_square``: a norm's mean of squares over a width cut over
  "model" (the sums of squares all-reduced, divided by the whole width);
* ``mlp``: SwiGLU or GELU with ``wi`` / ``wg`` column-parallel and ``wo``
  row-parallel (``row_out``, so with ``scatter_seq`` its output is the
  rank's block of the sequence);
* ``embed`` and ``head``: the vocab-parallel lookup (a rank looks up the
  tokens in its rows, zeroes the others and all-reduces) and the LM head
  (each rank its vocab columns, all-gathered over "model"). These two
  vocab-sized leaves are the exception to the fsdp gather: their "data"
  shard stays put and the activations move (the data group's tokens and
  looked-up rows, x and the partial logits), which is some hundred times
  fewer bytes at decode.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import meshctx


def model_size(mesh=None) -> int:
    """Ranks along "model" of ``mesh`` (default: the current one); 1
    without a mesh."""
    m = meshctx.get_mesh() if mesh is None else mesh
    return 1 if m is None or "model" not in m.axis_names else m.shape["model"]


def block_of(n, axes, mesh):
    """The slice of a dim of ``n`` that this rank of ``mesh`` (a process or
    counting mesh) holds when ``axes`` (None, an axis or a tuple) cut it."""
    if axes is None:
        return slice(0, n)
    k = math.prod(mesh.shape[a] for a in ((axes,) if isinstance(axes, str) else axes))
    if n % k:
        raise ValueError(f"a dim of {n} does not split over {k} ranks of {axes}")
    i = mesh.index(axes)
    return slice(i * (n // k), (i + 1) * (n // k))


def _spec(w):
    return getattr(w, "spec", None)


def gather(w):
    """``w`` whole on every dim cut over an axis other than "model" (its
    fsdp shard, gathered over "data")."""
    spec, mesh = _spec(w), meshctx.get_mesh()
    if spec is None or mesh is None:
        return w
    for dim, ax in enumerate(spec):
        if ax is not None and ax != "model":
            w = mesh.all_gather(w, ax, dim=dim)
    return w


def cuts(w, dim) -> bool:
    """Whether dim ``dim`` of parameter ``w`` is cut over "model"."""
    spec = _spec(w)
    return spec is not None and meshctx.get_mesh() is not None and spec[dim] == "model"


def cols(w) -> bool:
    return cuts(w, w.dim() - 1)


def rows(w) -> bool:
    return cuts(w, 0)


def row_out(h, w, scatter_seq=False):
    """``h @ w`` where ``h`` holds this rank's share of ``w``'s input dim
    when ``w`` is row-parallel, then summed over "model". With
    ``scatter_seq`` (h (B, S, k), the whole sequence) the rank keeps its
    block of the sum along S: the partial sums are reduce-scattered over
    "model" along dim 1 (whose transpose, the backward, all-gathers the
    cotangent), or, where ``w`` is not cut over "model", the rank takes
    its block of the whole product (``seq_block``)."""
    y = h @ gather(w)
    if scatter_seq:
        return meshctx.get_mesh().reduce_scatter(y, "model", dim=1) if rows(w) else seq_block(y)
    return meshctx.get_mesh().all_reduce(y, "model") if rows(w) else y


def seq_block(x):
    """This rank's contiguous block of S / model positions of ``x`` (B, S,
    ...), as a copy, so a remat group that keeps it does not keep the
    whole ``x`` alive through a view; its backward pads the cotangent with
    zeros (the other ranks' blocks carry the rest of the gradient)."""
    return x[:, block_of(x.shape[1], "model", meshctx.get_mesh())].clone()


def seq_gather(x):
    """The ranks' blocks of the sequence ``x`` (B, S / model, ...)
    all-gathered over "model" along dim 1, in index order: the whole
    sequence. Its transpose, the backward, reduce-scatters the cotangent
    along dim 1, each rank keeping its block of the sum."""
    return meshctx.get_mesh().all_gather(x, "model", dim=1)


def model_block(w, cut=True):
    """This rank's block along "model" of the replicated leaf ``w`` (its
    first dim) where ``cut``, as a view of the whole leaf: the rank reads
    only its block, and the gradient sync's sum over "model" (whose ranks
    each fill their block's rows of the leaf's gradient) assembles the
    whole gradient. ``w`` itself without a mesh or where ``cut`` is
    False."""
    mesh = meshctx.get_mesh()
    if not cut or mesh is None:
        return w
    return w[block_of(w.shape[0], "model", mesh)]


def mean_square(xf, cut=False):
    """The mean of ``xf * xf`` over its last dim (kept); where ``cut`` that
    dim is this rank's block of a width cut over "model", so the sums of
    squares are all-reduced over "model" and divided by the whole width
    (GSPMD's partial sum and all-reduce of the same mean)."""
    if not cut:
        return (xf * xf).mean(-1, keepdim=True)
    mesh = meshctx.get_mesh()
    total = mesh.all_reduce((xf * xf).sum(-1, keepdim=True), "model")
    return total / (xf.shape[-1] * model_size(mesh))


def mlp(x, wi, wg, wo, act="swiglu", scatter_seq=False):
    """``(silu(x wg) * (x wi)) wo`` (SwiGLU) or ``gelu(x wi) wo`` (tanh
    form), wi / wg column-parallel and wo row-parallel; with
    ``scatter_seq`` (x (B, S, d), the whole sequence) the rank's block of
    the output along S (``row_out``)."""
    if act == "swiglu":
        h = F.silu(x @ gather(wg)) * (x @ gather(wi))
    else:
        h = F.gelu(x @ gather(wi), approximate="tanh")
    return row_out(h, wo, scatter_seq)


def embed(w, tokens):
    """The rows of embedding ``w`` (V, d) for ``tokens``. With the vocab
    cut over "model", a rank looks up the tokens in its rows, zeroes the
    others, and the lookups are summed over "model" (exact: one row is not
    zero). With ``fsdp`` (d cut over "data") the leaf is not gathered: the
    rank looks up every token of its data group in its columns and the
    lookups are gathered over "data" along d, the rank keeping its rows (a
    lookup moves the tokens' rows, where the leaf, V / model x d / data,
    is hundreds of MB)."""
    spec, mesh = _spec(w), meshctx.get_mesh()
    if spec is None or mesh is None:
        return w[tokens]
    data = spec[1]
    whole = meshctx.batch_is_whole()
    toks = tokens if data is None or whole else mesh.all_gather(tokens, data, dim=0)
    if rows(w):
        n = w.shape[0]
        local = toks - mesh.index("model") * n
        mine = (local >= 0) & (local < n)
        e = mesh.all_reduce(w[local.clamp(0, n - 1)] * mine[..., None].to(w.dtype), "model")
    else:
        e = w[toks]
    if data is None:
        return e
    e = mesh.all_gather(e, data, dim=-1)
    return e if whole else e[block_of(e.shape[0], data, mesh)]


def head(x, w, *, tied=False):
    """The logits ``x @ w`` (``x @ w.T`` for a tied embedding (V, d)). With
    the vocab cut over "model" each rank computes its columns and they are
    all-gathered over "model", so every rank holds all of them. With
    ``fsdp`` (d cut over "data") the leaf is not gathered: the rank takes
    its data group's x, contracts its slice of d with its block, and the
    partial logits are summed over "data", the rank keeping its rows."""
    spec, mesh = _spec(w), meshctx.get_mesh()
    if spec is None or mesh is None:
        return x @ (w.T if tied else w)
    wt = w.T if tied else w
    data = spec[1 if tied else 0]
    if data is None:
        logits = x @ wt
    else:
        whole = meshctx.batch_is_whole()
        xs = x if whole else mesh.all_gather(x, data, dim=0)
        logits = mesh.all_reduce(xs[..., block_of(xs.shape[-1], data, mesh)] @ wt, data)
        logits = logits if whole else logits[block_of(logits.shape[0], data, mesh)]
    if cuts(w, 0 if tied else 1):
        logits = mesh.all_gather(logits, "model", dim=-1)
    return logits
