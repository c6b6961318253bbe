"""Fused (UE, server) pair scorer of the entity route policy.

Replaces ``src/repro/kernels/pair_scorer.py::pair_scorer_pallas`` (Pallas
TPU). One op computes, from raw per-UE vectors and the pool geometry:

  * the fleet-wide occupancy ``per_slot = sum(active) / (E * C)``,
  * the (E, 4) server rows and their tanh embedding (E, S),
  * per server, the three edge-feature columns (distance, clean-rate proxy
    ``log2(1 + p g / sigma)``, edge seconds), never stored,
  * the pair MLP with its first layer split by input block,
    ``tanh(ue @ W1u + srv_e @ W1s + edge_e @ W1e + b1) @ w2 + b2``,

and returns (route_logits (N, E), srv_emb (E, S)), both float32. Every
input but ``consts`` and the weights may carry a leading env axis B (the
reference ``vmap``s its ``pallas_call``): (B, N, d_ue), (B, N), (B, E, 3)
give (B, N, E) and (B, E, S), each env scored on its own.

On a CUDA tensor the wrapper launches the hand-written kernel of
``csrc/pair_scorer.cu`` or raises; on CPU or meta tensors it runs the plain twin.
The kernel is one launch of 8-UE blocks on a grid of (N / 8, B), laid out
before the launch by
``plan``: at entry one thread starts bulk copies of W1 and the block's UE
rows into shared memory (the ``"bulk"`` route, where d_ue and H are
multiples of 4 and ue_emb and w1 start on 16-byte boundaries; else the
``"loads"`` route, ordinary loads into the same padded layout). Six warps
then compute the ue term in 2 x 4 register tiles with K split over
``ue_split`` lanes, while two warps compute the edge triples, the
occupancy (each block sums the full ``active`` row in one fixed order, so
equal occupancy gives bitwise-equal logits), the server embedding and its
W1s term; one barrier joins them, and the pair stage spreads the hidden
units over 8 lanes a pair. At the serving size (N = 1024, E = 3) it is
bound by its critical path, not by work: its least work is ~14 MFLOP and
~0.6 MB.

``consts`` is the env's 8-vector (``MECEnv._scorer_consts``):
[pathloss, p_max, sigma_mean, omega_mean / RATE_NORM, t0, E * n_channels,
DIST_NORM, 1 / EDGE_SLOW_NORM].

The backward (the reference has no kernel for it: it differentiates
``pair_scorer_xla``) is ``csrc/pair_scorer_bwd.cu``, one cooperative launch
of at most one block an SM. A block takes units of at most 32 UE rows
(whole envs where N <= 32, laid out before the launch by
``backward_units``), recomputes each pair's edge triple and hidden layer,
forms da = g w2 tanh'(a) (as sech^2 of the pre-activation, which keeps its
digits where tanh rounds to 1) and from it d ue = (sum_e da) W1u^T, the
unit's dW1u = ue^T sum_e da, the edge-weight and bias sums and, for whole
envs, the env's server side (W1s, the server tanh, w_srv, b_srv); after one
grid barrier (two where an env spans units) every block sums a slice of the
outputs over the blocks' partials in block order, so the same call gives
the same bits. The call allocates only the returned gradients: the
workspace (the blocks' partials and the barrier's words) is kept per card
and stream. :class:`PairScorer` wires both kernels into autograd;
``pair_scorer_backward_plain`` is the same gradient as an explicit formula
in plain PyTorch, which CPU tensors run.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

C_PATHLOSS, C_PMAX, C_SIGMA, C_RATE_SCALE = 0, 1, 2, 3
C_T0, C_SLOT_DIV, C_DIST_NORM, C_SLOW_INV = 4, 5, 6, 7
N_CONSTS = 8
SRV_ROW = 4                 # [dist_scale, bw_scale, slowness, per_slot]
EDGE_COLS = 3
ROWS = 8            # UEs a block of the kernel
UE_THREADS = 192    # its six ue-term warps
TILE_ROWS = 2       # a thread's ue-term tile: 2 rows x 4 columns
SMEM_MAX = 232448   # the shared memory a block may take on Hopper
BWD_MAX_ROWS = 32   # UE rows a unit of the backward: one a lane of a warp
BWD_MAX_PAIRS = 16  # servers x envs a unit of whole envs holds at most


class Plan(NamedTuple):
    """The kernel's launch: ``blocks`` blocks of ``rows_per_block`` UEs an
    env, the ue term's K split over ``ue_split`` lanes, ``smem_bytes`` of
    shared memory and the copy ``route``."""
    rows_per_block: int
    blocks: int
    ue_split: int
    smem_bytes: int
    route: str


class BwdPlan(NamedTuple):
    """The backward's launch: units of ``envs_per_unit`` whole envs (0 where
    envs span units) or ``chunk_rows`` rows of one env (0 for whole envs),
    ``grid`` blocks (at most the blocks the card holds at once) walking
    ``units`` units, ``smem_bytes`` of shared memory, the workspace's floats
    (``part_floats`` a block, ``vpart_floats`` of the split envs' sums) and
    the copy ``route``."""
    envs_per_unit: int
    chunk_rows: int
    units: int
    grid: int
    smem_bytes: int
    part_floats: int
    vpart_floats: int
    route: str


def _up4(v: int) -> int:
    return (v + 3) // 4 * 4


def route(ue_emb, w1) -> str:
    """``"bulk"`` (W1 and the UE rows by bulk copy) where d_ue and H are
    multiples of 4 and both tensors start on a 16-byte boundary, else
    ``"loads"`` (ordinary loads into the same padded layout)."""
    ok = (ue_emb.shape[1] % 4 == 0 and w1.shape[1] % 4 == 0
          and ue_emb.data_ptr() % 16 == 0 and w1.data_ptr() % 16 == 0)
    return "bulk" if ok else "loads"


def smem_bytes(n_srv, d_ue, s_dim, hid) -> int:
    """The kernel's shared memory (``csrc/pair_scorer.cu``'s ``Layout``): W1
    with its ue rows and columns padded to multiples of 4, the block's UE
    rows and their W1u term, the servers' W1s term, b1, w2, the server
    embeddings, w_srv's per_slot row and b_srv, the edge triples, the
    occupancy partials, the mbarrier."""
    d4, h4 = _up4(d_ue), _up4(hid)
    floats = ((d4 + s_dim + EDGE_COLS) * h4 + ROWS * d4 + ROWS * h4 + n_srv * h4 + 2 * h4
              + _up4(n_srv * s_dim) + _up4(2 * s_dim) + _up4(ROWS * n_srv * EDGE_COLS) + 4)
    return 4 * floats + 8


def ue_split(d_ue, hid) -> int:
    """Lanes that split the ue term's K: the largest power of two (at most
    32) whose tiles x lanes fit the six ue warps, each part at least 4 deep.
    d_ue 128, H 48: 48 tiles x 4 lanes, 32 deep each."""
    tiles = ROWS // TILE_ROWS * (_up4(hid) // 4)
    split = 1
    while split < 32 and tiles * 2 * split <= UE_THREADS and 4 * 2 * split <= _up4(d_ue):
        split *= 2
    return split


def plan(n, n_srv, d_ue, s_dim, hid, copy_route) -> Plan:
    """The launch for N UEs and E servers an env by ``copy_route``; raises
    where the widths need more shared memory than a block has."""
    smem = smem_bytes(n_srv, d_ue, s_dim, hid)
    if smem > SMEM_MAX:
        raise ValueError(f"pair_scorer: E={n_srv}, d_ue={d_ue}, S={s_dim}, H={hid} need "
                         f"{smem} bytes of shared memory, more than a block's {SMEM_MAX}")
    return Plan(ROWS, -(-n // ROWS), ue_split(d_ue, hid), smem, copy_route)


def _dtype(*tensors):
    """float64 where every float input is float64 (the float64 twins of the
    tests), else float32, the kernels' type."""
    wide = all(t.dtype == torch.float64 for t in tensors if t.is_floating_point())
    return torch.float64 if wide else torch.float32


def _pair_scorer_plain_env(ue_emb, d, work, active, geom, consts,
                           w_srv, b_srv, w1, b1, w2, b2):
    dt = _dtype(ue_emb, d, work, active, geom, consts, w_srv, b_srv, w1, b1, w2, b2)
    f = lambda t: t.to(dt)
    ue_emb, d, work, active, geom, consts = map(f, (ue_emb, d, work, active, geom, consts))
    w_srv, b_srv, w1, b1, w2, b2 = map(f, (w_srv, b_srv, w1, b1, w2, b2))
    d_ue, s_dim = ue_emb.shape[1], w_srv.shape[1]
    per_slot = active.sum() / consts[C_SLOT_DIV]
    one = torch.ones_like(consts[C_SLOW_INV])
    srv_rows = torch.cat([
        geom * torch.stack([one, one, consts[C_SLOW_INV]]),
        per_slot.broadcast_to((geom.shape[0],))[:, None],
    ], dim=1)
    srv = torch.tanh(srv_rows @ w_srv + b_srv)                         # (E, S)
    dist = d[:, None] * geom[None, :, 0]                               # (N, E)
    gain = torch.pow(torch.clamp(dist, min=1.0), -consts[C_PATHLOSS])
    rate = (geom[:, 1] * consts[C_RATE_SCALE])[None, :] \
        * torch.log2(1.0 + consts[C_PMAX] * gain / consts[C_SIGMA])
    te = work[:, None] * geom[None, :, 2] / consts[C_T0]
    edge = torch.stack([dist / consts[C_DIST_NORM], rate, te], dim=-1)
    h = torch.tanh((ue_emb @ w1[:d_ue])[:, None, :]
                   + (srv @ w1[d_ue:d_ue + s_dim])[None, :, :]
                   + edge @ w1[d_ue + s_dim:]
                   + b1)                                               # (N, E, H)
    return (h @ w2 + b2)[..., 0], srv


def pair_scorer_plain(ue_emb, d, work, active, geom, consts,
                      w_srv, b_srv, w1, b1, w2, b2):
    """The kernel's function in plain PyTorch, in the decomposed form of
    ``pair_scorer_xla``: the first scorer layer split by input block, so
    the (N, E, d_ue+S+3) pair concat never exists. With an env axis each
    env is scored by its own call, so a batch gives the bits of B single
    calls. In float32, or in float64 where every float input is."""
    if ue_emb.dim() == 2:
        return _pair_scorer_plain_env(ue_emb, d, work, active, geom, consts,
                                      w_srv, b_srv, w1, b1, w2, b2)
    outs = [_pair_scorer_plain_env(ue_emb[b], d[b], work[b], active[b], geom[b], consts,
                                   w_srv, b_srv, w1, b1, w2, b2)
            for b in range(ue_emb.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _check_shapes(name, ue_emb, d, work, active, geom, consts, w_srv, b_srv, w1, b1, w2, b2):
    lead, (n, d_ue) = ue_emb.shape[:-2], ue_emb.shape[-2:]
    n_srv, s_dim, hid = geom.shape[-2], w_srv.shape[1], w1.shape[1]
    if (ue_emb.dim() not in (2, 3) or d.shape != (*lead, n) or work.shape != (*lead, n)
            or active.shape != (*lead, n) or geom.shape != (*lead, n_srv, 3)
            or consts.shape != (N_CONSTS,)
            or w_srv.shape != (SRV_ROW, s_dim) or b_srv.shape != (s_dim,)
            or w1.shape != (d_ue + s_dim + EDGE_COLS, hid) or b1.shape != (hid,)
            or w2.shape != (hid, 1) or b2.shape != (1,)):
        args = (ue_emb, d, work, active, geom, consts, w_srv, b_srv, w1, b1, w2, b2)
        raise ValueError(f"{name}: shapes do not agree: "
                         + ", ".join(str(tuple(a.shape)) for a in args))
    return lead, n, d_ue, n_srv, s_dim, hid


def pair_scorer(ue_emb, d, work, active, geom, consts,
                w_srv, b_srv, w1, b1, w2, b2):
    """ue_emb: (N, d_ue) or (B, N, d_ue); d, work, active: (N,) / (B, N);
    geom: (E, 3) / (B, E, 3); consts: (8,); w_srv: (4, S); b_srv: (S,); w1:
    (d_ue+S+3, H); b1: (H,); w2: (H, 1); b2: (1,). Any float dtype (cast to
    float32, as the reference casts before its call). Returns (logits (N,
    E), srv_emb (E, S)), with the env axis where the inputs have one."""
    args = (ue_emb, d, work, active, geom, consts, w_srv, b_srv, w1, b1, w2, b2)
    lead, n, d_ue, n_srv, s_dim, hid = _check_shapes("pair_scorer", *args)
    if _build.takes_twin("pair_scorer", *args):
        return pair_scorer_plain(*args)
    args = tuple(a.to(torch.float32).contiguous() for a in args)
    _build.require_cuda("pair_scorer", *args)
    if n == 0 or n_srv == 0 or 0 in lead:
        raise ValueError("pair_scorer: needs at least one env, UE and server")
    batch = lead[0] if lead else 1
    pl = plan(n, n_srv, d_ue, s_dim, hid, route(args[0], args[8]))
    logits = torch.empty((*lead, n, n_srv), dtype=torch.float32, device=ue_emb.device)
    srv = torch.empty((*lead, n_srv, s_dim), dtype=torch.float32, device=ue_emb.device)
    lib = _build.library()
    _build.check(lib.repro_pair_scorer(
        *(a.data_ptr() for a in args), logits.data_ptr(), srv.data_ptr(),
        n, n_srv, d_ue, s_dim, hid, batch, pl.ue_split, int(pl.route == "bulk"),
        pl.smem_bytes, _build.stream_of(logits)), "pair_scorer")
    _build.LAUNCHES["pair_scorer"] += 1
    return logits, srv


def _edge_triples(d, work, geom, consts):
    """(B, N, E, 3) edge features, as the forward builds them."""
    dist = d[..., :, None] * geom[..., None, :, 0]
    gain = torch.pow(torch.clamp(dist, min=1.0), -consts[C_PATHLOSS])
    rate = (geom[..., 1] * consts[C_RATE_SCALE])[..., None, :] \
        * torch.log2(1.0 + consts[C_PMAX] * gain / consts[C_SIGMA])
    te = work[..., :, None] * geom[..., None, :, 2] / consts[C_T0]
    return torch.stack([dist / consts[C_DIST_NORM], rate, te], dim=-1)


def _dtanh(x):
    """tanh'(x) = sech^2 x = 4 t / (1 + t)^2 with t = exp(-2|x|): accurate
    where tanh rounds to +-1, where 1 - tanh^2 would be 0 (the backward
    kernel takes the same form)."""
    t = torch.exp(-2.0 * x.abs())
    return 4.0 * t / ((1.0 + t) * (1.0 + t))


def pair_scorer_backward_plain(g_logits, g_srv, ue_emb, d, work, active, geom, consts,
                               w_srv, b_srv, w1, b1, w2, b2):
    """The gradients of ``pair_scorer`` for incoming gradients ``g_logits``
    (B, N, E) and ``g_srv`` (B, E, S), as an explicit formula in plain
    PyTorch (float32; float64 where every input is). Every input carries
    the env axis. Returns (d ue_emb in ue_emb's dtype, d w_srv, d b_srv, d
    w1, d b1, d w2, d b2). With a = ue W1u + srv W1s + edge W1e + b1, h =
    tanh(a) and da = g w2 tanh'(a): d ue = (sum_e da) W1u^T, dW1u = ue^T
    sum_e da, dW1s = srv^T sum_n da, dW1e = edge^T da; d srv = (sum_n da)
    W1s^T + g_srv goes through the server tanh into dw_srv and db_srv.
    tanh' is ``_dtanh`` of the pre-activation."""
    dt = _dtype(g_logits, g_srv, ue_emb, d, work, active, geom, consts, w_srv, b_srv, w1, b1,
                w2, b2)
    f = lambda t: t.to(dt)
    ue, d, work, active, geom, consts = map(f, (ue_emb, d, work, active, geom, consts))
    w_srv, b_srv, w1, b1, w2, b2, g, gs = map(f, (w_srv, b_srv, w1, b1, w2, b2, g_logits, g_srv))
    d_ue, s_dim = ue.shape[-1], w_srv.shape[1]
    w1u, w1s, w1e = w1[:d_ue], w1[d_ue:d_ue + s_dim], w1[d_ue + s_dim:]
    per_slot = active.sum(-1) / consts[C_SLOT_DIV]                      # (B,)
    rows = torch.cat([geom[..., :2], geom[..., 2:] * consts[C_SLOW_INV],
                      per_slot[:, None, None].expand(*geom.shape[:-1], 1)], dim=-1)
    srv_pre = rows @ w_srv + b_srv
    srv = torch.tanh(srv_pre)                                          # (B, E, S)
    edge = _edge_triples(d, work, geom, consts)                        # (B, N, E, 3)
    pre = ((ue @ w1u)[:, :, None, :] + (srv @ w1s)[:, None, :, :]
           + edge @ w1e + b1)                                          # (B, N, E, H)
    h = torch.tanh(pre)
    da = g[..., None] * w2[:, 0] * _dtanh(pre)
    u, v = da.sum(2), da.sum(1)                                        # (B, N, H), (B, E, H)
    dw1 = torch.cat([torch.einsum("bnd,bnh->dh", ue, u), torch.einsum("bes,beh->sh", srv, v),
                     torch.einsum("bnek,bneh->kh", edge, da)])
    dpre = (v @ w1s.T + gs) * _dtanh(srv_pre)                          # (B, E, S)
    return ((u @ w1u.T).to(ue_emb.dtype), torch.einsum("ber,bes->rs", rows, dpre),
            dpre.sum((0, 1)), dw1, da.sum((0, 1, 2)),
            torch.einsum("bne,bneh->h", g, h)[:, None], g.sum().reshape(1))


def backward_units(batch, n, n_srv, n_sm):
    """(envs a unit, chunk rows, units) of the backward for B envs of N UEs
    and E servers on ``n_sm`` SMs. Where N <= 32 a unit holds whole envs:
    as many as keep the grid within one wave, at most 32 rows and 16
    (env, server) pairs (2 envs a unit at the fleet demo's (256, 4, 2): 128
    units); else a chunk of one env, a multiple of 8 rows up to 32 that
    spreads the fleet over the SMs (8 rows at (1, 1024, 3): 128 units)."""
    if n <= BWD_MAX_ROWS:
        envs = max(1, min(BWD_MAX_ROWS // n, BWD_MAX_PAIRS // n_srv, -(-batch // n_sm)))
        return envs, 0, -(-batch // envs)
    rows = min(BWD_MAX_ROWS, max(8, -(-(-(-batch * n // n_sm)) // 8) * 8))
    return 0, rows, batch * -(-n // rows)


@functools.lru_cache(maxsize=None)
def _bwd_query(index, n, n_srv, batch, d_ue, s_dim, hid, envs, rows):
    """The library's layout and residency for a backward launch on card
    ``index``: (shared bytes, partial floats a block, split sums' floats,
    resident blocks), asked once a shape."""
    lib = _build.library()
    smem, part, vpart, resident = (ctypes.c_longlong(), ctypes.c_longlong(),
                                   ctypes.c_longlong(), ctypes.c_int())
    with torch.cuda.device(index):
        _build.check(lib.repro_pair_scorer_backward_plan(
            n, n_srv, batch, d_ue, s_dim, hid, envs, rows, ctypes.byref(smem),
            ctypes.byref(part), ctypes.byref(vpart), ctypes.byref(resident)),
            "pair_scorer_backward plan")
    return smem.value, part.value, vpart.value, resident.value


def backward_plan(batch, n, n_srv, d_ue, s_dim, hid, device, copy_route) -> BwdPlan:
    """The backward's launch on ``device`` (its SM count and the kernel's
    residency from the library); raises where the widths need more shared
    memory than a block has."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    envs, rows, units = backward_units(batch, n, n_srv, _build.sm_count(device))
    smem, part, vpart, resident = _bwd_query(index, n, n_srv, batch, d_ue, s_dim, hid, envs,
                                             rows)
    if smem > SMEM_MAX or resident < 1:
        raise ValueError(f"pair_scorer backward: E={n_srv}, d_ue={d_ue}, S={s_dim}, H={hid} "
                         f"need {smem} bytes of shared memory, more than a block's {SMEM_MAX}")
    return BwdPlan(envs, rows, units, min(units, resident), smem, part, vpart, copy_route)


_WORKSPACE: dict = {}


def _workspace(device, stream, floats):
    """The backward's workspace on ``device`` for ``stream``: at least
    ``floats`` floats (the blocks' partials, the split envs' sums) and the
    grid barrier's two words, [count, generation], zero when made. Every
    launch returns the count to zero; the generation only grows (one a
    barrier), and the barrier compares it for equality, so its value and
    its wrap-around do not matter. The workspace is reused as it is and
    grows only when a larger launch needs it."""
    key = (device, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws[0].numel() < floats:
        sync = ws[1] if ws is not None else torch.zeros(2, dtype=torch.int32, device=device)
        ws = (torch.empty(floats, dtype=torch.float32, device=device), sync)
        _WORKSPACE[key] = ws
    return ws


def pair_scorer_backward(g_logits, g_srv, ue_emb, d, work, active, geom, consts,
                         w_srv, b_srv, w1, b1, w2, b2, *, srv):
    """``pair_scorer_backward_plain``'s gradients by the backward kernel on
    CUDA tensors (every input with the env axis), its formula on CPU
    tensors. ``srv``: the (B, E, S) server embeddings the forward returned
    (the formula recomputes them)."""
    args = (ue_emb, d, work, active, geom, consts, w_srv, b_srv, w1, b1, w2, b2)
    if _build.takes_twin("pair_scorer_backward", *args, g_logits, g_srv):
        return pair_scorer_backward_plain(g_logits, g_srv, *args)
    _check_shapes("pair_scorer_backward", *args)
    f32 = tuple(a.to(torch.float32).contiguous() for a in args)
    g, gs, srv = (t.to(torch.float32).contiguous() for t in (g_logits, g_srv, srv))
    _build.require_cuda("pair_scorer_backward", *f32, g, gs, srv)
    ue, w1f = f32[0], f32[8]
    batch, n, d_ue = ue.shape
    n_srv, s_dim, hid = geom.shape[-2], w_srv.shape[1], w1.shape[1]
    if g.shape != (batch, n, n_srv) or gs.shape != (batch, n_srv, s_dim) \
            or srv.shape != gs.shape:
        raise ValueError(f"pair_scorer_backward: gradients {tuple(g.shape)}, "
                         f"{tuple(gs.shape)} and srv {tuple(srv.shape)} do not agree")
    dev = ue.device
    pl = backward_plan(batch, n, n_srv, d_ue, s_dim, hid, dev, route(ue, w1f))
    stream = _build.stream_of(ue)
    ws, sync = _workspace(dev, stream.value, pl.grid * pl.part_floats + pl.vpart_floats)
    due = torch.empty_like(ue)
    dw_srv, db_srv = torch.empty_like(f32[6]), torch.empty_like(f32[7])
    dw1 = torch.empty_like(w1f)
    db1, dw2, db2 = torch.empty_like(f32[9]), torch.empty_like(f32[10]), torch.empty_like(f32[11])
    lib = _build.library()
    _build.check(lib.repro_pair_scorer_backward(
        *(a.data_ptr() for a in f32[:11]), srv.data_ptr(), g.data_ptr(), gs.data_ptr(),
        due.data_ptr(), dw_srv.data_ptr(), db_srv.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
        dw2.data_ptr(), db2.data_ptr(), ws.data_ptr(),
        ws.data_ptr() + 4 * pl.grid * pl.part_floats, sync.data_ptr(), n, n_srv, d_ue, s_dim,
        hid, batch, pl.envs_per_unit, pl.chunk_rows, pl.units, pl.grid,
        int(pl.route == "bulk"), pl.smem_bytes, stream), "pair_scorer_backward")
    _build.LAUNCHES["pair_scorer_backward"] += 1
    return due.to(ue_emb.dtype), dw_srv, db_srv, dw1, db1, dw2, db2


class PairScorer(torch.autograd.Function):
    """``pair_scorer`` with its gradient: the forward kernel (the twin on
    CPU tensors) and, backward, ``pair_scorer_backward``. Inputs carry the
    env axis ((B, N, d_ue), ...); ``d``, ``work``, ``active``, ``geom`` and
    ``consts`` are observations and get no gradient."""

    @staticmethod
    def forward(ctx, ue_emb, d, work, active, geom, consts, w_srv, b_srv, w1, b1, w2, b2):
        logits, srv = pair_scorer(ue_emb, d, work, active, geom, consts, w_srv, b_srv, w1, b1,
                                  w2, b2)
        ctx.save_for_backward(ue_emb, d, work, active, geom, consts, w_srv, b_srv, w1, b1,
                              w2, b2, srv)
        return logits, srv

    @staticmethod
    def backward(ctx, g_logits, g_srv):
        *saved, srv = ctx.saved_tensors
        d_ue, dw_srv, db_srv, dw1, db1, dw2, db2 = pair_scorer_backward(g_logits, g_srv, *saved,
                                                                        srv=srv)
        return (d_ue, None, None, None, None, None, dw_srv, db_srv, dw1, db1, dw2, db2)
