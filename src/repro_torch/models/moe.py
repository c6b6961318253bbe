"""Mixture-of-experts FFN of the port: the reference's single-device
dispatch (``_apply_moe_global`` in ``src/repro/models/moe.py``).

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
so a call reads all E experts' weights. The expert-parallel paths of the
reference need a mesh and are not ported.

The dispatch makes no host sync: a dropped assignment is written to an
extra slot ``cap`` of the buffer, which no expert reads (torch refuses
an out-of-bounds index where XLA drops it), and gathered with weight 0.
``routing_log`` records the routing of every call made inside it.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import dtype_of, swiglu


class MoE(nn.Module):
    """The parameters in the reference's layouts: ``router`` (d, E) in
    float32 whatever the model's dtype, ``wi`` and ``wg`` (E, d, f), ``wo``
    (E, f, d), and with shared experts ``shared_wi`` / ``shared_wg`` (d, f
    n_shared) and ``shared_wo`` (f n_shared, d)."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        m = cfg.moe
        d, f, e = cfg.d_model, m.d_expert, m.n_experts
        dt = dtype_of(cfg.param_dtype)
        p = lambda *shape, dtype=dt: nn.Parameter(torch.empty(*shape, dtype=dtype,
                                                              device=device))
        self.cfg = cfg
        self.router = p(d, e, dtype=torch.float32)
        self.wi, self.wg, self.wo = p(e, d, f), p(e, d, f), p(e, f, d)
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
    counts = torch.bincount(e_flat, minlength=e)
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


def apply_moe(moe, x, cfg):
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, aux loss f32 scalar),
    the reference's ``_apply_moe_global`` over the B S tokens of the call."""
    m = cfg.moe
    b, s, d = x.shape
    t, e = b * s, m.n_experts
    cap = capacity(t, m)
    xf = x.reshape(t, d)
    probs = torch.softmax(xf.to(torch.float32) @ moe.router, dim=-1)
    r = route(probs, m.top_k, cap)
    for log in _LOGS:
        log.calls.append(r)

    # dispatch into (E, cap + 1, d): slot cap takes the dropped assignments
    slot = torch.clamp(r.rank, max=cap)
    buf = xf.new_zeros((e, cap + 1, d)).index_put((r.expert, slot), xf[r.token])[:, :cap]
    h = torch.bmm(buf, moe.wi)
    g = torch.bmm(buf, moe.wg)
    y = torch.bmm(F.silu(g) * h, moe.wo)

    # combine: a dropped assignment gathers a kept slot with weight 0; the
    # weighted outputs go back to their (token, j) places and each token
    # sums its k in f32 (a fixed order: no scatter-add, the same bits on
    # every run)
    w = r.top_p.reshape(t * m.top_k)[r.order] * r.kept
    gathered = y[r.expert, torch.clamp(r.rank, max=cap - 1)].to(torch.float32) * w[:, None]
    out = gathered.new_empty(gathered.shape).index_put((r.order,), gathered)
    out = out.reshape(t, m.top_k, d).sum(1).to(x.dtype)
    if m.n_shared_experts:
        out = out + swiglu(xf, moe.shared_wi, moe.shared_wg, moe.shared_wo)

    f_e = r.counts.to(torch.float32) / (t * m.top_k)
    aux = e * torch.sum(f_e * probs.mean(0)) * m.router_aux_weight
    return out.reshape(b, s, d), aux

