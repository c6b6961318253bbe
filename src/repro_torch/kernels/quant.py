"""Linear min-max quantize / dequantize (paper Eq. 1-2) on 2-D tensors.

Replaces ``src/repro/kernels/quant.py::quantize_2d`` and ``::dequantize_2d``
(Pallas TPU). On a CUDA tensor the wrappers launch the hand-written kernels
of ``csrc/quant.cu`` (bound by bytes on the H100: each takes four elements
a thread with one vector load and one vector store, and a view at any
element offset) or raise; on a CPU or meta tensor they run the plain twins,
which mirror ``quantize_xla`` / ``dequantize_xla`` op for op and give the
kernels' results bit for bit. Neither kernel has a backward: quantize
returns integer codes, and on CUDA tensors in grad mode dequantize refuses
an ``mn`` or ``mx`` tensor that requires grad (``_build.refuse_grad``),
since Eq. 2 is differentiable in them (``ref.dequantize_ref``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import code_dtype

_FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _f32(v) -> np.float32:
    return np.float32(float(v))


def _levels(bits: int) -> np.float32:
    if not 1 <= bits <= 16:
        raise ValueError(f"bits must be in [1, 16], got {bits}")
    return np.float32((1 << bits) - 1)


def quantize_plain(x, mn, mx, *, bits=8):
    """Eq. 1 in plain PyTorch, every step rounded to float32 like the kernel:
    ``clip(round((x - mn) * levels / max(mx - mn, 1e-12)), 0, levels)``."""
    levels = _levels(bits)
    mn, mx = _f32(mn), _f32(mx)
    scale = levels / np.maximum(mx - mn, np.float32(1e-12))
    # Python scalars holding float32 values enter a float32 op exactly, and
    # need no copy to the device.
    y = torch.round((x.to(torch.float32) - float(mn)) * float(scale))
    return torch.clamp(y, 0.0, float(levels)).to(code_dtype(bits))


def dequantize_plain(y, mn, mx, *, bits=8, out_dtype=torch.float32):
    """Eq. 2 with the kernel's association, ``y * ((mx - mn) / levels) + mn``."""
    levels = _levels(bits)
    mn, mx = _f32(mn), _f32(mx)
    step = (mx - mn) / levels
    return (y.to(torch.float32) * float(step) + float(mn)).to(out_dtype)


def quantize_2d(x, mn, mx, *, bits=8):
    """x: (M, N) float32/bfloat16; mn/mx: scalars. Returns (M, N) codes,
    uint8 for bits <= 8, else uint16."""
    if x.dim() != 2:
        raise ValueError(f"quantize_2d takes a 2-D tensor, got {tuple(x.shape)}")
    if _build.takes_twin("quantize", x):
        return quantize_plain(x, mn, mx, bits=bits)
    _build.require_cuda("quantize", x)
    if x.dtype not in _FLOAT_CODES:
        raise TypeError(f"quantize: unsupported dtype {x.dtype}")
    _levels(bits)
    out = torch.empty(x.shape, dtype=code_dtype(bits), device=x.device)
    if x.numel() == 0:
        return out
    lib = _build.library()
    _build.check(lib.repro_quantize(
        x.data_ptr(), out.data_ptr(), x.numel(), _FLOAT_CODES[x.dtype], bits,
        float(_f32(mn)), float(_f32(mx)), _build.stream_of(x)), "quantize")
    _build.LAUNCHES["quantize"] += 1
    return out


def dequantize_2d(y, mn, mx, *, bits=8, out_dtype=torch.float32):
    """y: (M, N) codes (uint8 for bits <= 8, else uint16). Returns (M, N)
    values of ``out_dtype`` (float32 or bfloat16)."""
    if y.dim() != 2:
        raise ValueError(f"dequantize_2d takes a 2-D tensor, got {tuple(y.shape)}")
    if _build.takes_twin("dequantize", y):
        return dequantize_plain(y, mn, mx, bits=bits, out_dtype=out_dtype)
    _build.refuse_grad("dequantize", mn, mx)
    _build.require_cuda("dequantize", y)
    _levels(bits)
    if y.dtype != code_dtype(bits):
        raise TypeError(f"dequantize: {bits}-bit codes must be "
                        f"{code_dtype(bits)}, got {y.dtype}")
    if out_dtype not in _FLOAT_CODES:
        raise TypeError(f"dequantize: unsupported out_dtype {out_dtype}")
    out = torch.empty(y.shape, dtype=out_dtype, device=y.device)
    if y.numel() == 0:
        return out
    lib = _build.library()
    _build.check(lib.repro_dequantize(
        y.data_ptr(), out.data_ptr(), y.numel(), _FLOAT_CODES[out_dtype], bits,
        float(_f32(mn)), float(_f32(mx)), _build.stream_of(y)), "dequantize")
    _build.LAUNCHES["dequantize"] += 1
    return out
