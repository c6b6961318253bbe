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
``csrc/pair_scorer.cu`` (8 UEs per block, weights in shared memory, one
warp per (UE, server) pair; each block recomputes the occupancy from the
full ``active`` row in one fixed order, so equal occupancy gives bitwise
equal logits) or raises. At the serving size (N = 1024, E = 3) it is
bound by launch latency: its least work is ~14 MFLOP and ~0.6 MB. On a CPU
tensor the wrapper runs the plain twin.

``consts`` is the env's 8-vector (``MECEnv._scorer_consts``):
[pathloss, p_max, sigma_mean, omega_mean / RATE_NORM, t0, E * n_channels,
DIST_NORM, 1 / EDGE_SLOW_NORM].
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

C_PATHLOSS, C_PMAX, C_SIGMA, C_RATE_SCALE = 0, 1, 2, 3
C_T0, C_SLOT_DIV, C_DIST_NORM, C_SLOW_INV = 4, 5, 6, 7
N_CONSTS = 8
SRV_ROW = 4                 # [dist_scale, bw_scale, slowness, per_slot]
EDGE_COLS = 3


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
    logits = torch.empty((n, n_srv), dtype=torch.float32, device=ue_emb.device)
    srv = torch.empty((n_srv, s_dim), dtype=torch.float32, device=ue_emb.device)
    if n == 0 or n_srv == 0:
        raise ValueError("pair_scorer: needs at least one UE and one server")
    lib = _build.library()
    _build.check(lib.repro_pair_scorer(
        *(a.data_ptr() for a in args), logits.data_ptr(), srv.data_ptr(),
        n, n_srv, d_ue, s_dim, hid, _build.stream_of(logits)), "pair_scorer")
    _build.LAUNCHES["pair_scorer"] += 1
    return logits, srv
