"""AdamW and Adafactor, the port of ``src/repro/optim/optimizers.py``'s
``global_norm``, ``adamw_init``, ``adamw_update``, ``_factored``,
``adafactor_init``, ``adafactor_update`` and ``opt_state_pspec`` (with
``opt_state_structs``, the shapes the reference's state takes, for the
dry-run's byte arithmetic).

The reference is functional over a params pytree; here the parameters are a
list of tensors (an agent's or a model's ``nn.Parameter``\\ s) updated in
place, and the state ``{"m", "v", "step"}`` holds one moment tensor per
parameter and the step count as an int32 tensor on the parameters' device.
The arithmetic is the reference's: ``b2 = 0.95`` by default, bias
corrections ``1 - b ** step`` computed on the device in float32, the step
``(m / bc1) / (sqrt(v / bc2) + eps)``, and the new parameter ``p - lr *
(update + wd * p)`` in float32, rounded to the parameter's dtype once.
Weight decay takes the leaves the reference decays, those of two or more
dimensions; a caller whose leaves have other ranks than the reference's
(a model, whose blocks the reference stacks on a layer axis) passes the
mask (``weights.reference_decay_mask``). The update runs as
``torch._foreach_*`` ops over all leaves at once, with no host sync.

Adafactor (the XL archs' optimizer: llama-3.2-vision-90b, kimi-k2-1t-a32b)
runs on the reference's leaves, which stack each block parameter of a
layer stack on a group axis. ``leaves`` describes them (``weights.
reference_leaves``: each leaf's parameter positions, whether they are
stacked and its rank in the reference); by default each parameter is a
leaf of its own rank. A leaf of rank 2 or more is factored: its row and
column second moments ``vr``, ``vc`` replace the full ``v``. So a per-layer
norm scale or bias, a (G, d) leaf in the reference, is factored, and its
``vc`` averages over the layers; the per-layer cross-attention gate, a
(G,) leaf, is not; a tail layer's leaves are not stacked. A stacked leaf
whose layers are matrices keeps ``vr`` and ``vc`` as one tensor a layer,
computed layer by layer (a layer of llama-3.2-vision-90b is 1.7 GB: the
stack is never formed), and its update's RMS, which the reference clips
over the whole leaf, sums the layers' squares; the 1-D and scalar leaves
are stacked. The new parameter is rounded to its dtype once.

Under a process mesh (a model built under ``meshctx.use_mesh``) each
parameter is a rank's block, with its live spec (``p.spec``) and whole
shape (``p.whole``). AdamW is elementwise and runs on the blocks as they
are. ``global_norm`` counts each element once: a leaf's sum of squares is
divided by the number of ranks that hold its block, and one all-reduce
over every axis sums them. Adafactor's means over a dim (``vr`` over the
last, ``vc`` over the next to last, ``rfac``'s mean of ``vr``) and the
RMS of its update over the whole leaf become sums all-reduced over the
axes that cut the dims reduced, divided by the whole leaf's dims; its
state is the rank's block of ``opt_state_pspec``.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence

import torch


def cut_axes(spec):
    """The mesh axes that cut some dim under ``spec`` (a live spec, or
    None), in the order they first appear."""
    out = []
    for ax in spec or ():
        for a in ((ax,) if isinstance(ax, str) else tuple(ax or ())):
            if a not in out:
                out.append(a)
    return tuple(out)


def replicas(spec, mesh) -> int:
    """The ranks of ``mesh`` that hold the same block of a leaf cut by
    ``spec``."""
    return mesh.size // math.prod(mesh.shape[a] for a in cut_axes(spec))


def global_norm(tree: Sequence[torch.Tensor], specs=None, mesh=None) -> torch.Tensor:
    """The L2 norm of all leaves together, in float32. Under ``mesh`` the
    leaves are a rank's blocks cut by ``specs`` (one live spec, or None,
    a leaf): each block's sum of squares over its ``replicas``, summed over
    every axis by one all-reduce, so each element counts once."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree))
    total = sum(torch.sum(torch.square(x.to(torch.float32))) / replicas(spec, mesh)
                for x, spec in zip(tree, specs))
    return torch.sqrt(mesh.all_reduce(total, mesh.axis_names))


def adamw_init(params: Sequence[torch.Tensor]):
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
    return {"m": zeros, "v": [z.clone() for z in zeros],
            "step": torch.zeros((), dtype=torch.int32, device=params[0].device)}


PASS_ELEMENTS = 1 << 26    # elements an AdamW pass or a gradient sync's buffer takes at once


def flat_passes(sizes, limit=PASS_ELEMENTS):
    """The leaves of ``sizes`` elements as passes of at most ``limit``
    elements: each pass a list of (leaf, start, stop) runs of the leaves'
    flattened elements, in order, a leaf larger than ``limit`` cut into
    runs."""
    passes, cur, n = [], [], 0
    for i, size in enumerate(sizes):
        for a in range(0, max(size, 1), limit):
            b = min(size, a + limit)
            if cur and n + b - a > limit:
                passes.append(cur)
                cur, n = [], 0
            cur.append((i, a, b))
            n += b - a
    return passes + ([cur] if cur else [])


@torch.no_grad()
def adamw_update(grads: Sequence[torch.Tensor], state, params: List[torch.Tensor], lr, *,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                 decay: Optional[Sequence[bool]] = None):
    """One AdamW step: updates ``params`` and the state's moments in place
    and returns ``(params, state)`` with the state's step advanced.
    ``decay[i]`` says whether parameter i takes weight decay; by default
    those of two or more dimensions, the reference's rule on its leaves.
    The leaves are updated in passes of at most ``PASS_ELEMENTS`` of their
    flattened elements (``flat_passes``), so the float32 temporaries of a
    pass stay a few hundred MB whatever the model's size; the arithmetic
    is elementwise, so the passes change no bit."""
    step = state["step"] + 1
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, sf)
    bc2 = 1 - torch.pow(b2, sf)
    m, v = state["m"], state["v"]
    if decay is None:
        decay = [p.dim() >= 2 for p in params]
    if len(decay) != len(params):
        raise ValueError(f"adamw_update: {len(decay)} decay flags for {len(params)} parameters")
    grads = [g.reshape(-1) for g in grads]
    flat = lambda ts, run: [ts[i].view(-1)[a:b] for i, a, b in run]
    for run in flat_passes([p.numel() for p in params]):
        _adamw_pass([grads[i][a:b] for i, a, b in run], flat(m, run), flat(v, run),
                    flat(params, run), [decay[i] for i, _, _ in run], lr, bc1, bc2,
                    b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    return params, {"m": m, "v": v, "step": step}


def _adamw_pass(grads, m, v, params, decay, lr, bc1, bc2, *, b1, b2, eps, weight_decay):
    """AdamW on one pass's runs of the leaves (flat views, updated in
    place)."""
    grads = [g.to(torch.float32) for g in grads]
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(v, b2)
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1 - b2)
    torch._foreach_add_(v, sq)
    del sq, grads
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(m, bc1)
    torch._foreach_div_(update, denom)
    del denom
    if weight_decay:
        idx = [i for i, d in enumerate(decay) if d]
        if idx:   # wd * p in float32, for bf16 leaves too
            torch._foreach_add_([update[i] for i in idx], torch._foreach_mul(
                [params[i].to(torch.float32) for i in idx], weight_decay))
    torch._foreach_mul_(update, lr)
    f32 = [i for i, p in enumerate(params) if p.dtype == torch.float32]
    if f32:
        torch._foreach_sub_([params[i] for i in f32], [update[i] for i in f32])
    for i, p in enumerate(params):
        if p.dtype != torch.float32:   # p - lr (update + wd p) in float32, rounded once
            p.copy_(p.to(torch.float32) - update[i])


class Leaf(NamedTuple):
    """A leaf of the reference's params tree, in the port's terms: the
    positions in the parameter list of the parameters it holds (one a
    group, stacked on a leading axis, where ``stacked``; else one), its
    rank in the reference (a stacked leaf's is its parameters' plus one)
    and its ``path`` there (dict keys and sequence indices)."""
    index: tuple
    stacked: bool
    rank: int
    path: tuple = ()


def _leaves(params, leaves):
    return leaves if leaves is not None else [Leaf((i,), False, p.dim())
                                              for i, p in enumerate(params)]


def _zeros(shape, device):
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _layerwise(leaf, params):
    """A stacked leaf whose layers are matrices: its moments and its update
    are kept one a layer."""
    return leaf.stacked and params[leaf.index[0]].dim() >= 2


def adafactor_init(params: Sequence[torch.Tensor], leaves=None):
    """Adafactor's state: ``{"slots": one dict a leaf, "step"}``. A factored
    leaf's slot is ``{"vr", "vc"}`` (lists of one tensor a layer for a
    stacked leaf of matrices), another's ``{"v"}``, all float32."""
    slots = []
    for leaf in _leaves(params, leaves):
        ps = [params[i] for i in leaf.index]
        dev = ps[0].device
        shape = ((len(ps),) if leaf.stacked else ()) + tuple(ps[0].shape)
        if leaf.rank < 2:
            slots.append({"v": _zeros(shape, dev)})
        elif _layerwise(leaf, params):
            slots.append({"vr": [_zeros(p.shape[:-1], dev) for p in ps],
                          "vc": [_zeros(p.shape[:-2] + p.shape[-1:], dev) for p in ps]})
        else:
            slots.append({"vr": _zeros(shape[:-1], dev),
                          "vc": _zeros(shape[:-2] + shape[-1:], dev)})
    return {"slots": slots, "step": torch.zeros((), dtype=torch.int32, device=params[0].device)}


class _Means:
    """Means over the dims of a leaf of shape ``whole`` that a rank holds
    as a block cut by ``spec`` (its live spec, a stacked leaf's with its
    group axis; None without a mesh): over a dim cut by some axes, the
    block's sum all-reduced over them and divided by the whole dim."""

    def __init__(self, whole, spec=None, mesh=None):
        self.spec, self.whole, self.mesh = spec, whole, mesh
        self.axes = cut_axes(spec)

    def over(self, x, dim, leaf_dim, keepdim=False):
        """The mean of ``x`` over its ``dim``, which is the leaf's
        ``leaf_dim``."""
        ax = self.spec[leaf_dim] if self.spec is not None else None
        if ax is None:
            return x.mean(dim, keepdim=keepdim)
        return self.mesh.all_reduce(x.sum(dim, keepdim=keepdim), ax) / self.whole[leaf_dim]

    def total(self, s):
        """A sum over the block's elements, summed over the leaf's ranks."""
        return self.mesh.all_reduce(s, self.axes) if self.axes else s

    def all(self, x):
        """The mean of ``x`` over the whole leaf."""
        return self.total(x.sum()) / math.prod(self.whole) if self.axes else x.mean()


def _leaf_means(leaf, params, mesh):
    """The ``_Means`` of a leaf: its live spec and whole shape from its
    parameters (``p.spec``, ``p.whole``) under ``mesh``, with the group
    axis of a stacked leaf whose layers are stacked into one tensor."""
    p = params[leaf.index[0]]
    spec = getattr(p, "spec", None) if mesh is not None else None
    whole = tuple(getattr(p, "whole", p.shape))
    if leaf.stacked and not _layerwise(leaf, params):
        whole = (len(leaf.index),) + whole
        spec = None if spec is None else (None,) + tuple(spec)
    return _Means(whole, spec, mesh)


def _moments(g, vr, vc, beta, eps, means):
    """The factored second moments' new values for the f32 gradient ``g``."""
    g2 = g * g + eps
    return (beta * vr + (1 - beta) * means.over(g2, -1, -1),
            beta * vc + (1 - beta) * means.over(g2, -2, -2))


def _scaled(g, vr, vc, eps, means):
    """The unclipped update of ``g`` by its factored moments."""
    rfac = torch.rsqrt(vr / torch.clamp(means.over(vr, -1, -2, keepdim=True), min=eps))
    return g * rfac[..., None] * torch.rsqrt(vc)[..., None, :]


@torch.no_grad()
def adafactor_update(grads: Sequence[torch.Tensor], state, params: List[torch.Tensor], lr, *,
                     decay=0.8, eps=1e-30, clip_thresh=1.0, weight_decay=0.0, leaves=None,
                     mesh=None):
    """One Adafactor step, the reference's: ``beta = 1 - step ** -decay``,
    second moments of ``g * g + eps`` (factored for a leaf of rank 2 or
    more), the update clipped to an RMS of ``clip_thresh`` over its leaf,
    ``p - lr * update`` (``- lr * weight_decay * p`` for a leaf of rank 2
    or more when ``weight_decay``) in float32, rounded to the parameter's
    dtype once. Updates ``params`` and the state in place; returns
    ``(params, state)`` with the step advanced. Under ``mesh`` the
    parameters are a rank's blocks (their ``spec`` and ``whole``) and the
    means over the whole leaf are taken across the ranks (``_Means``)."""
    step = state["step"] + 1
    beta = 1.0 - torch.pow(step.to(torch.float32), -decay)
    slots = []

    def apply(p, update, scale, wd):
        p2 = p.to(torch.float32) - lr * (update / scale)
        if wd:
            p2 = p2 - lr * weight_decay * p.to(torch.float32)
        p.copy_(p2)

    for leaf, slot in zip(_leaves(params, leaves), state["slots"]):
        ps = [params[i] for i in leaf.index]
        gs = [grads[i] for i in leaf.index]
        wd = bool(weight_decay) and leaf.rank >= 2
        means = _leaf_means(leaf, params, mesh)
        if _layerwise(leaf, params):
            # the moments layer by layer, and the update's squares; then the
            # same update again, clipped and applied (one layer's f32
            # gradient and update at a time)
            f32 = lambda g: g.to(torch.float32)
            moments = [_moments(f32(g), r, c, beta, eps, means)
                       for g, r, c in zip(gs, slot["vr"], slot["vc"])]
            sq = means.total(sum(torch.sum(torch.square(_scaled(f32(g), r, c, eps, means)))
                                 for g, (r, c) in zip(gs, moments)))
            scale = torch.clamp(torch.sqrt(sq / (len(gs) * math.prod(means.whole)))
                                / clip_thresh, min=1.0)
            for p, g, (r, c) in zip(ps, gs, moments):
                apply(p, _scaled(f32(g), r, c, eps, means), scale, wd)
            slots.append({"vr": [r for r, _ in moments], "vc": [c for _, c in moments]})
            continue
        gs = [g.to(torch.float32) for g in gs]
        g = torch.stack(gs) if leaf.stacked else gs[0]
        if leaf.rank >= 2:
            vr, vc = _moments(g, slot["vr"], slot["vc"], beta, eps, means)
            update = _scaled(g, vr, vc, eps, means)
            slots.append({"vr": vr, "vc": vc})
        else:
            v = beta * slot["v"] + (1 - beta) * (g * g + eps)
            update = g * torch.rsqrt(v)
            slots.append({"v": v})
        scale = torch.clamp(torch.sqrt(means.all(update * update)) / clip_thresh, min=1.0)
        for k, p in enumerate(ps):
            apply(p, update[k] if leaf.stacked else update, scale, wd)
    return params, {"slots": slots, "step": step}


def make_optimizer(name: str):
    """``(init, update)`` of the optimizer a config names: ``"adamw"`` or
    ``"adafactor"`` (whose init and update take ``leaves``, the reference's
    layout)."""
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(name)


def _slots(name, leaves):
    """(state path, param path, shape of the slot from the leaf's shape)
    of each slot the reference's init makes, for ``leaves`` of (path, rank):
    AdamW's ``m`` and ``v``; Adafactor's ``vr`` (the last dim dropped) and
    ``vc`` (the next to last dropped) for a leaf of rank two or more, else
    its ``v``."""
    if name not in ("adamw", "adafactor"):
        raise ValueError(name)
    for path, rank in leaves:
        if name == "adamw":
            yield ("m",) + path, path, lambda s: s
            yield ("v",) + path, path, lambda s: s
        elif rank >= 2:
            yield ("slots",) + path + ("vr",), path, lambda s: s[:-1]
            yield ("slots",) + path + ("vc",), path, lambda s: s[:-2] + s[-1:]
        else:
            yield ("slots",) + path + ("v",), path, lambda s: s


def opt_state_structs(name: str, params):
    """The reference's optimizer state of a params tree (``{path: tensor}``,
    the reference's leaves, e.g. ``sharding.reference_params``) as
    ``{path: meta tensor}``, the shapes and dtypes its ``opt_init`` gives:
    float32 slots and an int32 ``step``."""
    out = {state: torch.empty(shape_of(tuple(params[path].shape)), dtype=torch.float32,
                              device="meta")
           for state, path, shape_of in _slots(name, [(p, t.dim()) for p, t in params.items()])}
    out[("step",)] = torch.empty((), dtype=torch.int32, device="meta")
    return out


def opt_state_pspec(name: str, params_specs):
    """Specs of the optimizer state, derived from the params' specs
    (``{path: spec}``; the reference's ``opt_state_pspec``): AdamW's ``m``
    and ``v`` take the params' specs, Adafactor's ``vr`` drops a spec's
    last entry and ``vc`` its next to last (for a spec of two entries or
    more; another leaf keeps one ``v``), and ``step`` is replicated. The
    paths are those of ``opt_state_structs``."""
    out = {state: shape_of(tuple(params_specs[path]))
           for state, path, shape_of in _slots(name, [(p, len(s))
                                                      for p, s in params_specs.items()])}
    out[("step",)] = ()
    return out
