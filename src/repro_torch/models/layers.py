"""Basic layers of the port: norms, MLP, RoPE and initializers
(``src/repro/models/layers.py``). The ops are plain functions on tensors;
``Norm`` and ``MLP`` hold their parameters in the reference's layouts
(weights as (d_in, d_out), applied as ``x @ w``)."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import tp


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------- init utils
def dense_init(generator, shape, dtype, device, scale: float = 1.0):
    """Normal with std ``scale / sqrt(fan_in)``, drawn in f32 then cast."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale / np.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return w.mul_(float(std)).to(dtype)


def embed_init(generator, shape, dtype, device):
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------- norms
def apply_norm(x, scale, bias=None, *, norm="rmsnorm", eps: float = 1e-6):
    """RMSNorm or LayerNorm over the last dim, computed in f32 and cast back
    to x's dtype."""
    xf = x.to(torch.float32)
    if norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * scale.to(torch.float32) + bias.to(torch.float32)
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)
    return y.to(x.dtype)


def rms_head_norm(scale, x, eps: float = 1e-6):
    """Per-head RMSNorm (qk_norm); x: (..., d_head)."""
    xf = x.to(torch.float32)
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)).to(x.dtype)


class Norm(nn.Module):
    def __init__(self, cfg, d=None, *, device=None):
        super().__init__()
        d = d or cfg.d_model
        dt = dtype_of(cfg.param_dtype)
        self.norm = cfg.norm
        self.scale = nn.Parameter(torch.ones(d, dtype=dt, device=device))
        self.bias = (nn.Parameter(torch.zeros(d, dtype=dt, device=device))
                     if cfg.norm == "layernorm" else None)

    def forward(self, x):
        return apply_norm(x, self.scale, self.bias, norm=self.norm)


# ---------------------------------------------------------------- MLP
class MLP(nn.Module):
    """SwiGLU ``(silu(x wg) * (x wi)) wo`` or GELU (tanh form, as
    ``jax.nn.gelu``) ``gelu(x wi) wo``."""

    def __init__(self, cfg, d_ff=None, *, device=None):
        super().__init__()
        d, f = cfg.d_model, (d_ff or cfg.d_ff)
        dt = dtype_of(cfg.param_dtype)
        self.act = cfg.act
        self.wi = nn.Parameter(torch.empty(d, f, dtype=dt, device=device))
        self.wg = (nn.Parameter(torch.empty(d, f, dtype=dt, device=device))
                   if cfg.act == "swiglu" else None)
        self.wo = nn.Parameter(torch.empty(f, d, dtype=dt, device=device))

    def forward(self, x, scatter_seq=False):
        """Under a mesh ``wi`` / ``wg`` are column-parallel and ``wo``
        row-parallel (``tp.mlp``); with ``scatter_seq`` the output is the
        rank's block of the sequence."""
        return tp.mlp(x, self.wi, self.wg, self.wo, self.act, scatter_seq)


def swiglu(x, wi, wg, wo):
    """``(silu(x wg) * (x wi)) wo``, in x's dtype."""
    return (F.silu(x @ wg) * (x @ wi)) @ wo


# ---------------------------------------------------------------- RoPE
@functools.lru_cache(maxsize=None)
def rope_inv_freqs(d_rot, theta, device):
    """RoPE's inverse frequencies, built in numpy with the reference's bits
    and copied to ``device`` once per (d_rot, theta, device): a copy from
    the host on every call would synchronise the stream."""
    inv = 1.0 / (theta ** (np.arange(0, d_rot, 2, dtype=np.float32) / d_rot))
    with torch.inference_mode(False):     # usable in and out of inference mode
        return torch.from_numpy(inv.astype(np.float32)).to(device)


def rope_freqs(positions, d_head, theta, fraction=1.0):
    """positions: (..., S) int -> cos/sin (..., S, d_rot//2), d_rot."""
    d_rot = int(d_head * fraction)
    d_rot -= d_rot % 2
    inv = rope_inv_freqs(d_rot, theta, positions.device)
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang), d_rot


def apply_rope(x, positions, theta, fraction=1.0):
    """x: (B, S, H, D); positions: (B, S). Rotates interleaved pairs
    (x[..., 0::2], x[..., 1::2]), not the half-split convention."""
    cos, sin, d_rot = rope_freqs(positions, x.shape[-1], theta, fraction)
    if d_rot == 0:
        return x
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out.to(x.dtype), xp], dim=-1)
