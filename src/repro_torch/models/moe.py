"""Mixture-of-experts FFN of the port: the reference's single-device
dispatch (``_apply_moe_global``) and its two expert-parallel paths
(``apply_moe_ep``, ``apply_moe_ep_decode``), all in
``src/repro/models/moe.py``.

An f32 router picks each token's top-k experts; a stable sort over the
T k assignments gives each one its rank within its expert; tokens are
scattered into an (E, cap, d) buffer, where an assignment ranked ``cap``
or later is dropped; the experts run as three batched products; each
kept assignment's output is summed in f32, weighted by its
renormalised probability (the reference scatter-adds; the port sums each
token's k outputs in a fixed order, so a run on the card gives the same
bits twice), and the shared experts' SwiGLU is added. The
aux loss is the Switch load-balance term ``E sum_e f_e p_e`` times
``router_aux_weight``. Every expert runs over its whole capacity buffer,
so a call reads all E experts' weights.

Under a mesh (``meshctx``) where ``ep_available`` holds, a rank holds the
experts ``[lo, lo + E / model)`` of its "model" index, and with ``fsdp``
its d-slice of them over "data"; ``apply_moe`` picks the reference's path
by the global token count (``moe_path``). The reference writes these
paths as per-shard code inside ``shard_map``; here they are what each rank
runs, its ``psum`` and tiled ``all_gather`` the mesh's collectives.
Elsewhere under a mesh (a batch the data ranks do not divide, held whole
on every rank inside ``meshctx.whole_batch``, or one they do where no
expert-parallel path exists) the single-device dispatch runs over every
data rank's tokens, gathered unless the batch is whole, as GSPMD
partitions the reference's: over the rank's experts, summed over
"model", where the experts are sharded, else over whole experts. The
router and the shared experts follow the rules too (``tp``): the router
gathered over "data" with ``fsdp``, the shared experts' ``wi`` / ``wg``
column-parallel and ``wo`` row-parallel.

Under a sequence-parallel residual (``meshctx.seq_parallel``) the block
hands ``apply_moe`` its normed input gathered whole along the sequence,
so the path, the routing, the capacity, the dropped share and the aux
loss are those of the whole sequence, and with ``scatter_seq`` the
combine's sum over "model" (and the shared experts' row-parallel
product) is reduce-scattered along the sequence where it was
all-reduced; where nothing is summed over "model" the rank takes its
block of the output.

The dispatch makes no host sync: an assignment this rank does not keep
is written to an extra slot ``cap`` of an extra expert ``e_loc`` of the
buffer, which no expert reads (torch refuses an out-of-bounds index where
XLA drops it), and gathered from a kept slot with weight 0.
``routing_log`` records the routing of every call made inside it, on
every path, once: not again in a train step's recompute (``unlogged``).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import meshctx, tp
from repro_torch.models.layers import dtype_of

DECODE_TOKENS = 4096     # apply_moe's decode regime: at most this many tokens in all


class MoE(nn.Module):
    """The parameters in the reference's layouts: ``router`` (d, E) in
    float32 whatever the model's dtype, ``wi`` and ``wg`` (E, d, f), ``wo``
    (E, f, d), and with shared experts ``shared_wi`` / ``shared_wg`` (d, f
    n_shared) and ``shared_wo`` (f n_shared, d). Built under a mesh where
    ``ep_available`` holds, the expert leaves are the rank's shard
    (``expert_shard``): (E / model, d / data or d, f) and (E / model, f,
    d / data or d); ``shard`` is that (rows, d slice), None when whole."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        m = cfg.moe
        d, f, e = cfg.d_model, m.d_expert, m.n_experts
        dt = dtype_of(cfg.param_dtype)
        p = lambda *shape, dtype=dt: nn.Parameter(torch.empty(*shape, dtype=dtype,
                                                              device=device))
        self.cfg = cfg
        self.shard = expert_shard(cfg, meshctx.get_mesh())
        self.router = p(d, e, dtype=torch.float32)
        ei, di = e, d
        if self.shard is not None:
            rows, dsl = self.shard
            ei, di = rows.stop - rows.start, len(range(d)[dsl])
        self.wi, self.wg, self.wo = p(ei, di, f), p(ei, di, f), p(ei, f, di)
        if m.n_shared_experts:
            fs = f * m.n_shared_experts
            self.shared_wi, self.shared_wg, self.shared_wo = p(d, fs), p(d, fs), p(fs, d)

    def forward(self, x):
        return apply_moe(self, x, self.cfg)


@dataclass
class Routing:
    """One call's routing. Per token (T rows): ``probs`` (T, E) f32, the
    renormalised ``top_p`` and the expert ids ``top_e`` (T, k). Per
    assignment in the stable sort's order (T k): ``order`` (its flat index
    t k + j), ``expert``, ``rank`` within the expert, ``token`` and
    ``kept`` (rank < cap). ``counts`` (E,) counts every assignment, the
    dropped ones included."""
    probs: torch.Tensor
    top_p: torch.Tensor
    top_e: torch.Tensor
    order: torch.Tensor
    expert: torch.Tensor
    rank: torch.Tensor
    token: torch.Tensor
    kept: torch.Tensor
    counts: torch.Tensor
    cap: int


def capacity(t, m):
    """Slots an expert holds for a call of ``t`` tokens."""
    return max(1, math.ceil(t * m.top_k / m.n_experts * m.capacity_factor))


def route(probs, k, cap):
    """The routing of router probabilities ``probs`` (T, E) f32 at top-k
    and capacity ``cap``: the reference's top-k, renormalisation by
    max(sum, 1e-9), stable sort and ranks (``moe.py:72-84``)."""
    t, e = probs.shape
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    e_flat = top_e.reshape(t * k)
    order = torch.argsort(e_flat, stable=True)
    expert = e_flat[order]
    # bincount's length depends on the data, so it has no meta kernel: the
    # count as a scatter-add into E slots (integer sums: the same on any run)
    counts = torch.zeros(e, dtype=e_flat.dtype, device=e_flat.device).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=probs.device) - offsets[expert]
    return Routing(probs, top_p, top_e, order, expert, rank, order // k, rank < cap, counts, cap)


class RoutingLog:
    """What ``routing_log`` collects: each call's ``Routing``, in call
    order. Recording launches nothing: the dropped share is counted when
    it is read."""

    def __init__(self):
        self.calls = []

    def dropped_share(self):
        """The dropped share of the assignments, or None if no MoE ran."""
        if not self.calls:
            return None
        kept = torch.cat([r.kept for r in self.calls])
        return float((~kept).sum()) / kept.numel()


_LOGS = []
_PAUSED = [0]


@contextlib.contextmanager
def routing_log():
    """Records the routing of every ``apply_moe`` call inside the block
    into the yielded ``RoutingLog``."""
    log = RoutingLog()
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


@contextlib.contextmanager
def unlogged():
    """No routing is recorded inside the block: a train step's recomputed
    forward (``cfg.remat``) routes the calls its first run recorded."""
    _PAUSED[0] += 1
    try:
        yield
    finally:
        _PAUSED[0] -= 1


def expert_shard(cfg, mesh):
    """This rank's shard of the expert leaves under ``mesh`` (a process
    mesh): (the rows ``[lo, lo + E / model)`` of its "model" index, the
    d-slice of its "data" index with ``fsdp``, else the whole d), the
    reference's ``wspec_i`` / ``wspec_o``; None where the leaves stay whole
    (no mesh, or no expert-parallel path for ``cfg`` on it)."""
    if mesh is None or not meshctx.ep_available(cfg, mesh):
        return None
    e_loc = cfg.moe.n_experts // mesh.shape["model"]
    lo = mesh.index("model") * e_loc
    dsl = slice(None)
    if cfg.fsdp:
        d_loc = cfg.d_model // mesh.shape["data"]
        dsl = slice(mesh.index("data") * d_loc, (mesh.index("data") + 1) * d_loc)
    return slice(lo, lo + e_loc), dsl


def expert_leaf_shape(cfg, name):
    """The whole shape of expert leaf ``name``: "wi", "wg" (E, d, f), "wo"
    (E, f, d)."""
    m = cfg.moe
    if name == "wo":
        return (m.n_experts, m.d_expert, cfg.d_model)
    return (m.n_experts, cfg.d_model, m.d_expert)


def shard_expert_leaf(name, a, shard):
    """Expert leaf ``name`` ("wi", "wg": (E, d, f); "wo": (E, f, d)), a
    tensor or an array, cut to ``shard`` (rows, d slice)."""
    rows, dsl = shard
    a = a[rows]
    return a[:, dsl] if name in ("wi", "wg") else a[:, :, dsl]


def moe_path(cfg, mesh, batch, seq):
    """The path ``apply_moe`` takes for a call of ``batch`` x ``seq``
    tokens in all (every data rank's together) under ``mesh``, by the
    reference's rules: "ep_decode" with ``fsdp``, at most
    ``DECODE_TOKENS`` tokens, a batch the data ranks divide and d_model
    the "data" axis divides; else "ep" for a batch they divide; else
    "global" (also without an expert-parallel path)."""
    if not meshctx.ep_available(cfg, mesh):
        return "global"
    dp = meshctx.dp_size(mesh)
    if (cfg.fsdp and batch * seq <= DECODE_TOKENS and batch % dp == 0
            and cfg.d_model % mesh.shape["data"] == 0):
        return "ep_decode"
    return "ep" if batch % dp == 0 else "global"


def apply_moe(moe, x, cfg, scatter_seq=False):
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, aux loss f32 scalar).
    Without a mesh the reference's ``_apply_moe_global`` over the B S
    tokens of the call. Under a mesh x is the rank's shard of the batch,
    and the path is ``moe_path``'s for the global batch B x dp; with
    ``scatter_seq`` (x the whole sequence under a sequence-parallel
    residual) out is the rank's block (B, S / model, d)."""
    mesh = meshctx.get_mesh()
    whole = moe.shard is None
    if mesh is None:
        if not whole:
            raise ValueError("this MoE holds a shard of its experts; run it under the mesh "
                             "it was built under (meshctx.use_mesh)")
        return _apply_single(moe, x, cfg)
    if moe.shard != expert_shard(cfg, mesh):
        raise ValueError("this MoE's expert leaves were not built under the current mesh")
    dp = meshctx.dp_axes(mesh)
    path = moe_path(cfg, mesh, meshctx.global_batch(x.shape[0], mesh), x.shape[1])
    if path == "ep_decode":
        return apply_moe_ep_decode(moe, x, cfg, mesh, scatter_seq)
    if path == "ep":
        return apply_moe_ep(moe, x, cfg, mesh, scatter_seq)
    # every data rank's tokens through the global dispatch, as GSPMD runs the
    # reference's; this rank keeps its own rows
    run = (lambda xs: _apply_single(moe, xs, cfg, scatter_seq) if whole
           else _apply_global_ep(moe, xs, cfg, mesh, scatter_seq))
    if meshctx.batch_is_whole():
        return run(x)
    b = x.shape[0]
    out, aux = run(mesh.all_gather(x, dp))
    i = mesh.index(dp)
    return out[i * b:(i + 1) * b], aux


def _log(r):
    if _PAUSED[0]:
        return
    for log in _LOGS:
        log.calls.append(r)


def _aux(r, probs, m, t):
    f_e = r.counts.to(torch.float32) / (t * m.top_k)
    return m.n_experts * torch.sum(f_e * probs.mean(0)) * m.router_aux_weight


def _combine(xf, r, lo, e_loc, experts):
    """Dispatch the assignments of experts ``[lo, lo + e_loc)`` that ``r``
    keeps into an (e_loc, cap, d) buffer, run ``experts(buf)`` -> (e_loc,
    cap, d), and return each token's weighted sum of its kept outputs in
    f32, (T, d). The other assignments go to the unread slot (e_loc, cap)
    and are gathered from slot (0, 0) with weight 0; each token sums its k
    in a fixed order (no scatter-add)."""
    t, d = xf.shape
    k = r.top_e.shape[1]
    el = r.expert - lo
    mine = (el >= 0) & (el < e_loc) & r.kept
    buf = xf.new_zeros((e_loc + 1, r.cap + 1, d)).index_put(
        (torch.where(mine, el, e_loc), torch.where(mine, r.rank, r.cap)), xf[r.token])
    y = experts(buf[:e_loc, :r.cap])
    w = r.top_p.reshape(t * k)[r.order] * mine
    gathered = y[torch.where(mine, el, 0), torch.where(mine, r.rank, 0)].to(torch.float32) \
        * w[:, None]
    out = gathered.new_empty(gathered.shape).index_put((r.order,), gathered)
    return out.reshape(t, k, d).sum(1)


def _swiglu_experts(wi, wg, wo):
    return lambda buf: torch.bmm(F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wi), wo)


def _shared(moe, x, m, scatter_seq=False):
    """The shared experts' SwiGLU of x (..., d), or 0 without them; with
    ``scatter_seq`` (x (B, S, d)) the rank's block along S."""
    if not m.n_shared_experts:
        return 0
    return tp.mlp(x, moe.shared_wi, moe.shared_wg, moe.shared_wo, scatter_seq=scatter_seq)


def _finish(moe, x, comb, m, mesh=None, scatter_seq=False):
    """The combine ``comb`` (T, d) f32 of x's (B, S, d) tokens in x's
    dtype, summed over "model" under ``mesh`` (each rank combined its own
    experts), plus the shared experts of x: (B, S, d). With
    ``scatter_seq`` the rank's block of S / model positions: the sum is
    reduce-scattered along S, or without ``mesh`` the block is taken."""
    b, s, d = x.shape
    if not scatter_seq:
        out = comb.to(x.dtype)
        if mesh is not None:
            out = mesh.all_reduce(out, "model")
        return (out + _shared(moe, x.reshape(b * s, d), m)).reshape(b, s, d)
    out = comb.to(x.dtype).reshape(b, s, d)
    out = tp.seq_block(out) if mesh is None else mesh.reduce_scatter(out, "model", dim=1)
    return out + _shared(moe, x, m, scatter_seq=True)


def _probs(moe, xf):
    return torch.softmax(xf.to(torch.float32) @ tp.gather(moe.router), dim=-1)


def _apply_single(moe, x, cfg, scatter_seq=False):
    """The reference's ``_apply_moe_global`` over the B S tokens of x."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    probs = _probs(moe, xf)
    r = route(probs, m.top_k, capacity(t, m))
    _log(r)
    out = _combine(xf, r, 0, m.n_experts, _swiglu_experts(moe.wi, moe.wg, moe.wo))
    return _finish(moe, x, out, m, scatter_seq=scatter_seq), _aux(r, probs, m, t)


def _apply_global_ep(moe, x, cfg, mesh, scatter_seq=False):
    """The reference's ``_apply_moe_global`` over all the tokens of x, its
    experts sharded as ``expert_shard`` holds them: every rank routes all
    the tokens at the global capacity, runs its E / model experts (with
    ``fsdp`` gathered over "data" along d), and the f32 combine, cast to
    x's dtype, is summed over "model"."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e_loc = m.n_experts // mesh.shape["model"]
    wi, wg, wo = moe.wi, moe.wg, moe.wo
    if cfg.fsdp:
        wi, wg = mesh.all_gather(wi, "data", dim=1), mesh.all_gather(wg, "data", dim=1)
        wo = mesh.all_gather(wo, "data", dim=2)
    xf = x.reshape(t, d)
    probs = _probs(moe, xf)
    r = route(probs, m.top_k, capacity(t, m))
    _log(r)
    out = _combine(xf, r, mesh.index("model") * e_loc, e_loc, _swiglu_experts(wi, wg, wo))
    return _finish(moe, x, out, m, mesh, scatter_seq), _aux(r, probs, m, t)


def apply_moe_ep(moe, x, cfg, mesh, scatter_seq=False):
    """The reference's ``apply_moe_ep`` as one rank runs it. x: the rank's
    (b, S, d) tokens, routed locally at capacity ``max(4, ceil(b S k / E
    cf))``; with ``fsdp`` the expert shards are all-gathered over "data"
    along d; only this rank's E / model experts run, and the f32 combine,
    cast to x's dtype, is summed over "model" (the reference's ``psum``).
    The aux loss is averaged over the data axes. The shared experts run on
    the rank's tokens."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e_loc = m.n_experts // mesh.shape["model"]
    cap = max(4, math.ceil(t * m.top_k / m.n_experts * m.capacity_factor))
    wi, wg, wo = moe.wi, moe.wg, moe.wo
    if cfg.fsdp:
        wi, wg = mesh.all_gather(wi, "data", dim=1), mesh.all_gather(wg, "data", dim=1)
        wo = mesh.all_gather(wo, "data", dim=2)
    xf = x.reshape(t, d)
    probs = _probs(moe, xf)
    r = route(probs, m.top_k, cap)
    _log(r)
    out = _combine(xf, r, mesh.index("model") * e_loc, e_loc, _swiglu_experts(wi, wg, wo))
    out = _finish(moe, x, out, m, mesh, scatter_seq)
    dp = meshctx.dp_axes(mesh)
    aux = mesh.all_reduce(_aux(r, probs, m, t), dp) / meshctx.dp_size(mesh)
    return out, aux


def apply_moe_ep_decode(moe, x, cfg, mesh, scatter_seq=False):
    """The reference's ``apply_moe_ep_decode`` as one rank runs it: the
    expert leaves stay sharded (E over "model", d over "data"); every data
    rank's tokens are gathered and routed at capacity ``max(4, ceil(T k /
    E cf))`` over all T of them; h and g are contracted over the rank's
    d-slice and summed over "data", y is gathered over "data" along d,
    combined, summed over "model", and the rank keeps its own tokens. The
    aux loss (over all tokens) is not averaged. A prefill or train step of
    at most ``DECODE_TOKENS`` tokens takes this path too; there, with
    ``scatter_seq``, the combine is reduce-scattered along S."""
    m = cfg.moe
    b, s, d = x.shape
    dp = meshctx.dp_axes(mesh)
    e_loc = m.n_experts // mesh.shape["model"]
    d_loc = d // mesh.shape["data"]
    xall = mesh.all_gather(x, dp)
    t = xall.shape[0] * s
    cap = max(4, math.ceil(t * m.top_k / m.n_experts * m.capacity_factor))
    xf = xall.reshape(t, d)
    probs = _probs(moe, xf)
    r = route(probs, m.top_k, cap)
    _log(r)
    di = mesh.index("data") * d_loc

    def experts(buf):
        part = buf[:, :, di:di + d_loc]
        h = mesh.all_reduce(torch.bmm(part, moe.wi), "data")
        g = mesh.all_reduce(torch.bmm(part, moe.wg), "data")
        return mesh.all_gather(torch.bmm(F.silu(g) * h, moe.wo), "data", dim=2)

    out = _combine(xf, r, mesh.index("model") * e_loc, e_loc, experts).to(x.dtype)
    if scatter_seq:
        out = mesh.reduce_scatter(out.reshape(-1, s, d), "model", dim=1)
    else:
        out = mesh.all_reduce(out, "model").reshape(-1, s, d)
    i = mesh.index(dp)
    return out[i * b:(i + 1) * b] + _shared(moe, x, m, scatter_seq), _aux(r, probs, m, t)
