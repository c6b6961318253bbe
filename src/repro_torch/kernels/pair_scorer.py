"""Fused (UE, server) pair scorer of the entity route policy.

Replaces ``src/repro/kernels/pair_scorer.py::pair_scorer_pallas`` (Pallas
TPU). One op computes, from raw per-UE vectors and the pool geometry:

  * the fleet-wide occupancy ``per_slot = sum(active) / (E * C)``,
  * the (E, 4) server rows and their tanh embedding (E, S),
  * per server, the three edge-feature columns (distance, clean-rate proxy
    ``log2(1 + p g / sigma)``, edge seconds), never stored,
  * the pair MLP with its first layer split by input block,
    ``tanh(ue @ W1u + srv_e @ W1s + edge_e @ W1e + b1) @ w2 + b2``,

and returns (route_logits (N, E), srv_emb (E, S)), both float32.

On a CUDA tensor the wrapper launches the hand-written kernel of
``csrc/pair_scorer.cu`` or raises; on a CPU tensor it runs the plain twin.
The kernel is one launch of 8-UE blocks, laid out before the launch by
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
"""
from __future__ import annotations

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


class Plan(NamedTuple):
    """The kernel's launch: ``blocks`` blocks of ``rows_per_block`` UEs, the
    ue term's K split over ``ue_split`` lanes, ``smem_bytes`` of shared memory
    and the copy ``route``."""
    rows_per_block: int
    blocks: int
    ue_split: int
    smem_bytes: int
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
    """The launch for N UEs and E servers by ``copy_route``; raises where
    the widths need more shared memory than a block has."""
    smem = smem_bytes(n_srv, d_ue, s_dim, hid)
    if smem > SMEM_MAX:
        raise ValueError(f"pair_scorer: E={n_srv}, d_ue={d_ue}, S={s_dim}, H={hid} need "
                         f"{smem} bytes of shared memory, more than a block's {SMEM_MAX}")
    return Plan(ROWS, -(-n // ROWS), ue_split(d_ue, hid), smem, copy_route)


def pair_scorer_plain(ue_emb, d, work, active, geom, consts,
                      w_srv, b_srv, w1, b1, w2, b2):
    """The kernel's function in plain PyTorch, in the decomposed form of
    ``pair_scorer_xla``: the first scorer layer split by input block, so
    the (N, E, d_ue+S+3) pair concat never exists."""
    f = lambda t: t.to(torch.float32)
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


def pair_scorer(ue_emb, d, work, active, geom, consts,
                w_srv, b_srv, w1, b1, w2, b2):
    """ue_emb: (N, d_ue); d, work, active: (N,); geom: (E, 3); consts:
    (8,); w_srv: (4, S); b_srv: (S,); w1: (d_ue+S+3, H); b1: (H,); w2:
    (H, 1); b2: (1,). Any float dtype (cast to float32, as the reference
    casts before its call). Returns (logits (N, E), srv_emb (E, S))."""
    args = (ue_emb, d, work, active, geom, consts, w_srv, b_srv, w1, b1, w2, b2)
    n, d_ue = ue_emb.shape
    n_srv, s_dim, hid = geom.shape[0], w_srv.shape[1], w1.shape[1]
    if (d.shape != (n,) or work.shape != (n,) or active.shape != (n,)
            or geom.shape != (n_srv, 3) or consts.shape != (N_CONSTS,)
            or w_srv.shape != (SRV_ROW, s_dim) or b_srv.shape != (s_dim,)
            or w1.shape != (d_ue + s_dim + EDGE_COLS, hid) or b1.shape != (hid,)
            or w2.shape != (hid, 1) or b2.shape != (1,)):
        raise ValueError("pair_scorer: shapes do not agree: "
                         + ", ".join(str(tuple(a.shape)) for a in args))
    if all(a.device.type == "cpu" for a in args):
        return pair_scorer_plain(*args)
    args = tuple(a.to(torch.float32).contiguous() for a in args)
    _build.require_cuda("pair_scorer", *args)
    if n == 0 or n_srv == 0:
        raise ValueError("pair_scorer: needs at least one UE and one server")
    pl = plan(n, n_srv, d_ue, s_dim, hid, route(args[0], args[8]))
    logits = torch.empty((n, n_srv), dtype=torch.float32, device=ue_emb.device)
    srv = torch.empty((n_srv, s_dim), dtype=torch.float32, device=ue_emb.device)
    lib = _build.library()
    _build.check(lib.repro_pair_scorer(
        *(a.data_ptr() for a in args), logits.data_ptr(), srv.data_ptr(),
        n, n_srv, d_ue, s_dim, hid, pl.ue_split, int(pl.route == "bulk"), pl.smem_bytes,
        _build.stream_of(logits)), "pair_scorer")
    _build.LAUNCHES["pair_scorer"] += 1
    return logits, srv
