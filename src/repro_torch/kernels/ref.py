"""Plain PyTorch oracles for the port's kernels, mirroring
``src/repro/kernels/ref.py`` op for op (including where it does its
scalar arithmetic in Python, before the range reaches float32)."""
from __future__ import annotations

import torch


def code_dtype(bits: int) -> torch.dtype:
    return torch.uint8 if bits <= 8 else torch.uint16


def quantize_ref(x, mn, mx, bits=8):
    """Linear min-max quantization (paper Eq. 1) with static calibration."""
    levels = (1 << bits) - 1
    scale = levels / torch.clamp(torch.as_tensor(mx - mn, dtype=torch.float32),
                                 min=1e-12)
    y = torch.clamp(torch.round((x.to(torch.float32) - mn) * scale), 0, levels)
    return y.to(code_dtype(bits))


def dequantize_ref(y, mn, mx, bits=8):
    """Paper Eq. 2."""
    levels = (1 << bits) - 1
    return y.to(torch.float32) * (mx - mn) / levels + mn


def bottleneck_encode_ref(x, w, mn, mx, bits=8):
    """Fused compressor encode: (T, d) @ (d, d') then quantize."""
    z = x.to(torch.float32) @ w.to(torch.float32)
    return quantize_ref(z, mn, mx, bits)


def ssd_intra_ref(xh, dt, la, Bm, Cm):
    """SSD intra-chunk oracle (mirrors models/ssm.ssd_chunked's intra part).
    xh: (B, NC, Q, H, P); dt, la: (B, NC, Q, H); Bm, Cm: (B, NC, Q, N)."""
    q = xh.shape[2]
    seg = la[:, :, :, None, :] - la[:, :, None, :, :]   # (B,NC,i,j,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=la.device))
    seg = torch.where(mask[None, None, :, :, None], seg, -1e30)
    cb = torch.einsum("bcin,bcjn->bcij", Cm, Bm)
    w = cb[..., None] * torch.exp(seg) * dt[:, :, None, :, :]
    return torch.einsum("bcijh,bcjhp->bcihp", w, xh)
