"""RG-LRU recurrent mixer (RecurrentGemma / Griffin, arXiv:2402.19427),
ported from ``src/repro/models/rglru.py``:

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
    a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x_t))
    i_t = sigmoid(W_x x_t)

after a causal depthwise conv of width 4, with a GELU gate on the output.
The full-sequence path runs the linear recurrence as a log-step
(Hillis-Steele) scan over the sequence with the reference's combine
``(a_l a_r, a_r b_l + b_r)``: ceil(log2 L) tensor passes instead of one
step a token (the reference uses ``jax.lax.associative_scan``, whose tree
sums in another order). Decode is a one-step update. The gates and the
recurrence run in f32; it has no kernel.

Under a mesh (``meshctx``) both are the program one rank runs under the
reference's rules: ``wx``, ``wgate``, ``conv_w`` and ``conv_b`` cut on
d_rnn, so a rank holds its d_rnn / model columns of the branch, the gate
and the conv; ``wa`` and ``wi`` cut on their output columns, while their
products contract over the whole d_rnn, so the rank's branch after the
conv is all-gathered over "model" before the two gate products, and each
rank computes its columns of ``a`` and ``b``; ``ba``, ``bi`` and ``lam``
replicated, each read as its block (``tp.model_block``); the scan and the
decode update elementwise over d_rnn, so a rank runs its columns; ``out``
row-parallel. The state is the rank's columns (``conv`` and ``h`` cut on
d_rnn by the cache rules). Under a sequence-parallel residual
(``meshctx.seq_parallel``) the block hands in its normed input gathered
whole along the sequence (the conv and the scan need all of it), and
``out``'s partial sums are reduce-scattered along it (``scatter_seq``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import meshctx, tp
from repro_torch.models.layers import dtype_of
from repro_torch.models.ssm import softplus

C_CONST = 8.0
D_CONV = 4


class RGLRU(nn.Module):
    """The mixer's parameters, with the reference's names and layouts
    (d_rnn = d_model); ``ba``, ``bi`` and ``lam`` are float32 whatever
    ``param_dtype``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        d = d_rnn = cfg.d_model
        dt = dtype_of(cfg.param_dtype)
        e = lambda shape, dtype=dt: nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
        self.cfg = cfg
        self.wx = e((d, d_rnn))
        self.wgate = e((d, d_rnn))
        self.conv_w = e((D_CONV, d_rnn))
        self.conv_b = e((d_rnn,))
        self.wa = e((d_rnn, d_rnn))
        self.ba = e((d_rnn,), torch.float32)
        self.wi = e((d_rnn, d_rnn))
        self.bi = e((d_rnn,), torch.float32)
        self.lam = e((d_rnn,), torch.float32)
        self.out = e((d_rnn, d))

    def forward(self, x, state=None):
        return apply_rglru(self, x, self.cfg, state=state)


def _gates(p, xc, local=False):
    """xc: (..., d_rnn), the branch after the conv (with ``local`` this
    rank's columns of it). Returns (a, b) in f32, the rank's columns."""
    xf = xc.to(torch.float32)
    whole = meshctx.get_mesh().all_gather(xf, "model", dim=-1) if local else xf
    ra = torch.sigmoid(whole @ tp.gather(p.wa).to(torch.float32)
                       + tp.model_block(p.ba, local))
    ii = torch.sigmoid(whole @ tp.gather(p.wi).to(torch.float32)
                       + tp.model_block(p.bi, local))
    log_a = -C_CONST * softplus(tp.model_block(p.lam, local)) * ra
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (ii * xf)
    return a, b


def _conv(p, x, init_state=None):
    """Causal depthwise conv over time. x: (B, L, d_rnn). Returns (y, the
    last d_conv - 1 inputs: the state, zero-padded when L < d_conv - 1 and
    no state came in)."""
    pad = p.conv_w.shape[0] - 1
    if init_state is None:
        xpad = F.pad(x, (0, 0, pad, 0))
    else:
        xpad = torch.cat([init_state.to(x.dtype), x], dim=1)
    y = sum(xpad[:, i:i + x.shape[1], :] * p.conv_w[i] for i in range(pad + 1))
    return y + p.conv_b, xpad[:, -pad:, :]


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along dim 1, as an inclusive
    Hillis-Steele scan: at offset k = 1, 2, 4, ... each step t >= k takes
    the combine of step t - k and itself, ``(a_l a_r, a_r b_l + b_r)``."""
    k, n = 1, a.shape[1]
    while k < n:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b


def apply_rglru(p, x, cfg, *, state=None, scatter_seq=False):
    """x: (B, L, d). Returns (out, new state {"conv", "h"}); with
    ``scatter_seq`` (x the whole sequence under a sequence-parallel
    residual) out is the rank's block of L / model positions
    (``tp.row_out``), the state still that of the whole sequence."""
    local = tp.cols(p.wx)
    xb = x @ tp.gather(p.wx)
    gate = x @ tp.gather(p.wgate)
    xc, conv_state = _conv(p, xb, None if state is None else state["conv"])
    a, b = _gates(p, xc, local)                          # (B, L, D) f32
    if state is not None:
        # fold h0 into the first step: b_0 += a_0 * h0
        b = torch.cat([b[:, :1] + a[:, :1] * state["h"][:, None], b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    out = tp.row_out(h.to(x.dtype) * F.gelu(gate, approximate="tanh"), p.out, scatter_seq)
    return out, {"conv": conv_state, "h": h[:, -1].to(torch.float32)}


def decode_rglru(p, x, cfg, state):
    """One-step decode. x: (B, 1, d); state {"conv": (B, 3, D), "h": (B,
    D)}. Returns (out, new state); the state passed in is not changed."""
    local = tp.cols(p.wx)
    xb = x @ tp.gather(p.wx)
    gate = x @ tp.gather(p.wgate)
    xin = torch.cat([state["conv"].to(xb.dtype), xb], dim=1)
    xc = sum(xin[:, i, :] * p.conv_w[i] for i in range(p.conv_w.shape[0])) + p.conv_b
    a, b = _gates(p, xc, local)                          # (B, D)
    hnew = a * state["h"] + b
    out = tp.row_out(hnew[:, None, :].to(x.dtype) * F.gelu(gate, approximate="tanh"), p.out)
    return out, {"conv": xin[:, 1:, :], "h": hnew}
