"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060], ported from
``src/repro/models/ssm.py``: the full-sequence forward (chunked SSD, the
quadratic intra-chunk term through ``ops.ssd_intra`` and a linear
inter-chunk scan). n_groups is fixed to 1 (B/C shared across heads), as in
the mamba2-1.3b config. The projections are separate (d_in, d_out)
matrices applied as ``x @ w``, as in the reference. All recurrence math
runs in f32. ``decode_mamba`` is the one-token recurrent step from the
state ``apply_mamba`` returns; it has no kernel.

Under a mesh (``meshctx``) both are the program one rank runs under the
reference's rules: ``wz``, ``wx`` and ``wdt`` column-parallel, so a rank
holds its H / model heads (d_inner is head-major, so its block of ``wx``'s
columns is a run of whole heads) and its channels of ``conv_x`` and
``conv_x_b``; ``wbc`` and ``conv_bc`` replicated, so every rank computes B
and C whole; ``A_log``, ``D``, ``dt_bias`` and ``norm_scale`` replicated,
each read as its block (``tp.model_block``); the gated norm's mean over
d_inner one all-reduce of the sums of squares over "model"
(``tp.mean_square``); ``out_proj`` row-parallel. ``ssd_intra`` runs on the
rank's heads. The state is the rank's blocks as the cache rules cut it:
``h`` by heads, ``conv_x`` by channels, ``conv_bc`` whole. Where the
residual is sequence-parallel (``seq_parallel_residual``,
``meshctx.seq_parallel``) the block gathers its input along the sequence
before the mixer (the causal conv and the scan need the whole sequence),
and ``apply_mamba(..., scatter_seq=True)`` reduce-scatters ``out_proj``'s
partial sums along the sequence instead of all-reducing them; the mixer in
between, and every value, is unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import tp
from repro_torch.models.layers import dtype_of


def dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads, s.head_dim, s.d_state, s.d_conv


def softplus(x):
    """``log(exp(x) + 1)`` as ``jax.nn.softplus`` computes it (logaddexp,
    with no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


class Mamba(nn.Module):
    """The mixer's parameters, with the reference's names and layouts;
    ``A_log``, ``D`` and ``dt_bias`` are float32 whatever ``param_dtype``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        d = cfg.d_model
        d_inner, h, _, n, d_conv = dims(cfg)
        dt = dtype_of(cfg.param_dtype)
        f32 = torch.float32
        e = lambda shape, dtype=dt: nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
        self.cfg = cfg
        self.wz = e((d, d_inner))
        self.wx = e((d, d_inner))
        self.wbc = e((d, 2 * n))
        self.wdt = e((d, h))
        self.conv_x = e((d_conv, d_inner))
        self.conv_x_b = e((d_inner,))
        self.conv_bc = e((d_conv, 2 * n))
        self.conv_bc_b = e((2 * n,))
        self.A_log = e((h,), f32)
        self.D = e((h,), f32)
        self.dt_bias = e((h,), f32)
        self.norm_scale = e((d_inner,))
        self.out_proj = e((d_inner, d))

    def forward(self, x, state=None):
        return apply_mamba(self, x, self.cfg, state=state)


def _conv_seq(w, b, x, init_state=None):
    """Depthwise causal conv over time. x: (B, L, C). Returns (y, state)."""
    d_conv = w.shape[0]
    pad = d_conv - 1
    if init_state is None:
        xpad = F.pad(x, (0, 0, pad, 0))
    else:
        xpad = torch.cat([init_state.to(x.dtype), x], dim=1)
    y = sum(xpad[:, i:i + x.shape[1], :] * w[i] for i in range(d_conv))
    return F.silu(y + b), xpad[:, -pad:, :]


def _conv_step(w, b, x1, state):
    """One-step conv. x1: (B, C); state: (B, d_conv-1, C)."""
    d_conv = w.shape[0]
    xin = torch.cat([state.to(x1.dtype), x1[:, None, :]], dim=1)
    y = sum(xin[:, i, :] * w[i] for i in range(d_conv))
    return F.silu(y + b), xin[:, 1:, :]


def _gated_norm(p, y, z, eps=1e-6, local=False):
    """RMSNorm of ``y * silu(z)`` over d_inner; with ``local`` y and z are
    this rank's channels of it."""
    yf = (y * F.silu(z)).to(torch.float32)
    ms = tp.mean_square(yf, local)
    return yf * torch.rsqrt(ms + eps) * tp.model_block(p.norm_scale, local).to(torch.float32)


def _heads_held(p, cfg):
    """Whether this rank runs its heads only: "model" cuts ``wx``'s
    columns (a mesh whose model axis divides d_inner). The rules cut
    ``wdt`` only where the axis divides the heads; a mixer whose d_inner
    splits and whose heads do not has no program."""
    if not tp.cols(p.wx):
        return False
    if not tp.cols(p.wdt):
        raise ValueError(f"{cfg.name}: a model axis of {tp.model_size()} splits d_inner but not "
                         f"the {dims(cfg)[1]} heads of a mamba2 mixer")
    return True


def _mixer_inputs(p, x):
    """z, x's branch, B and C's branch and dt: x times ``wz``, ``wx``,
    ``wbc`` and ``wdt`` (each gathered whole on its fsdp dims)."""
    return tuple(x @ tp.gather(w) for w in (p.wz, p.wx, p.wbc, p.wdt))


def ssd_chunked(xh, dth, a_log, Bm, Cm, chunk, h0=None):
    """Chunked SSD.

    xh: (B, L, H, P) inputs; dth: (B, L, H) f32 (post-softplus);
    a_log: (B, L, H) f32 = -exp(A_log)*dt (log decay per step);
    Bm, Cm: (B, L, N) f32; h0: (B, H, P, N) initial state or None.
    The intra-chunk quadratic goes through ``ops.ssd_intra`` (the CUDA
    kernel on the card, its plain twin on the CPU).
    Returns y (B, L, H, P) f32, final state (B, H, P, N) f32.
    """
    b, l, h, pdim = xh.shape
    n = Bm.shape[-1]
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dth = F.pad(dth, (0, 0, 0, pad))
        a_log = F.pad(a_log, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = xh.shape[1] // q
    xh = xh.reshape(b, nc, q, h, pdim)
    dth = dth.reshape(b, nc, q, h)
    a_log = a_log.reshape(b, nc, q, h)
    Bm = Bm.reshape(b, nc, q, n)
    Cm = Cm.reshape(b, nc, q, n)

    la = torch.cumsum(a_log, dim=2)                     # (B,nc,Q,H) inclusive
    y_intra = ops.ssd_intra(xh, dth, la, Bm, Cm)

    # chunk states: contribution of chunk c to the state at its end
    last = la[:, :, -1:, :]                             # (B,nc,1,H)
    dec_to_end = torch.exp(last - la)                   # (B,nc,Q,H)
    st = torch.einsum("bcqh,bcqn,bcqhp->bchpn", dec_to_end * dth, Bm, xh)

    # inter-chunk scan, emitting the state at each chunk's start
    chunk_decay = torch.exp(la[:, :, -1, :])            # (B,nc,H)
    hprev = (torch.zeros((b, h, pdim, n), dtype=torch.float32, device=xh.device)
             if h0 is None else h0)
    starts = []
    for c in range(nc):
        starts.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + st[:, c]
    hstart = torch.stack(starts, dim=1)                 # (B,nc,H,P,N)

    # inter contribution: y_inter[i] = exp(la_i) * C_i . h_start
    y_inter = torch.einsum("bcqh,bcqn,bchpn->bcqhp", torch.exp(la), Cm, hstart)
    y = (y_intra + y_inter).reshape(b, nc * q, h, pdim)[:, :l]
    return y, hprev


def apply_mamba(p, x, cfg, *, state=None, scatter_seq=False):
    """Full-sequence forward (train/prefill). x: (B, L, d).
    state: optional {"conv_x","conv_bc","h"} to resume. Returns
    (out, new_state); with ``scatter_seq`` (a sequence-parallel residual)
    out is this rank's block of L / model positions (``tp.row_out``)."""
    pdim = cfg.ssm.head_dim
    b, l, _ = x.shape
    local = _heads_held(p, cfg)
    z, xs, bc, dt = _mixer_inputs(p, x)
    h = dt.shape[-1]                                    # the heads this rank holds
    cx = None if state is None else state["conv_x"]
    cbc = None if state is None else state["conv_bc"]
    h0 = None if state is None else state["h"]
    xs, conv_x_state = _conv_seq(p.conv_x, p.conv_x_b, xs, cx)
    bc, conv_bc_state = _conv_seq(p.conv_bc, p.conv_bc_b, bc, cbc)
    Bm, Cm = torch.chunk(bc, 2, dim=-1)
    xh = xs.reshape(b, l, h, pdim).to(torch.float32)
    dtf = softplus(dt.to(torch.float32) + tp.model_block(p.dt_bias, local))
    a_log = -torch.exp(tp.model_block(p.A_log, local)) * dtf     # (B,L,H)
    y, hlast = ssd_chunked(xh, dtf, a_log, Bm.to(torch.float32),
                           Cm.to(torch.float32), cfg.ssm.chunk, h0)
    y = y + tp.model_block(p.D, local)[None, None, :, None] * xh
    y = y.reshape(b, l, h * pdim)
    out = tp.row_out(_gated_norm(p, y, z.to(torch.float32), local=local).to(x.dtype),
                     p.out_proj, scatter_seq=scatter_seq)
    return out, {"conv_x": conv_x_state, "conv_bc": conv_bc_state, "h": hlast}


def decode_mamba(p, x, cfg, state):
    """One-token decode. x: (B, 1, d); state {"conv_x": (B, d_conv-1, di),
    "conv_bc": (B, d_conv-1, 2N), "h": (B, H, P, N)}. Returns (out, new
    state); the state passed in is not changed."""
    pdim = cfg.ssm.head_dim
    b = x.shape[0]
    local = _heads_held(p, cfg)
    z, xs, bc, dt = _mixer_inputs(p, x)
    xs, bc, dt = xs[:, 0], bc[:, 0], dt[:, 0]
    h = dt.shape[-1]
    xs, new_cx = _conv_step(p.conv_x, p.conv_x_b, xs, state["conv_x"])
    bc, new_cbc = _conv_step(p.conv_bc, p.conv_bc_b, bc, state["conv_bc"])
    Bm, Cm = torch.chunk(bc, 2, dim=-1)
    xh = xs.reshape(b, h, pdim).to(torch.float32)
    dtf = softplus(dt.to(torch.float32) + tp.model_block(p.dt_bias, local))   # (B,H)
    a = torch.exp(-torch.exp(tp.model_block(p.A_log, local)) * dtf)          # (B,H)
    hnew = (state["h"] * a[:, :, None, None]
            + torch.einsum("bh,bn,bhp->bhpn", dtf, Bm.to(torch.float32), xh))
    yh = torch.einsum("bn,bhpn->bhp", Cm.to(torch.float32), hnew)
    yh = yh + tp.model_block(p.D, local)[None, :, None] * xh
    out = tp.row_out(_gated_norm(p, yh.reshape(b, 1, h * pdim), z.to(torch.float32),
                                 local=local).to(x.dtype), p.out_proj)
    return out, {"conv_x": new_cx, "conv_bc": new_cbc, "h": hnew}
