"""Fused compressor encode, ``codes = quantize(x @ W_enc)`` (paper Eq. 1).

Replaces ``src/repro/kernels/bottleneck.py::bottleneck_encode`` (Pallas
TPU): the whole UE-side cost of the compressor for transformer hidden
states. On a CUDA tensor the wrapper launches the hand-written SIMT kernel
of ``csrc/bottleneck.cu`` (64 x 64 output tiles, K walked inside the block,
f32 FMA accumulation, the quantize as its epilogue, so z never reaches
memory) or raises. It is bound by operations on the H100 (2*T*d*d' f32
FMAs; tensor cores are not used, since TF32 would move codes by more than
one). On a CPU tensor the wrapper runs the plain twin.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant import _FLOAT_CODES, _f32, _levels, quantize_plain
from repro_torch.kernels.ref import code_dtype


def bottleneck_encode_plain(x, w, mn, mx, *, bits=8):
    """The kernel's function in plain PyTorch: an f32 matmul, then Eq. 1."""
    z = x.to(torch.float32) @ w.to(torch.float32)
    return quantize_plain(z, mn, mx, bits=bits)


def bottleneck_encode(x, w, mn, mx, *, bits=8):
    """x: (T, d); w: (d, d'), both float32 or both bfloat16; mn/mx: the
    calibrated quantization range. Returns (T, d') codes, uint8 for
    bits <= 8, else uint16."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"bottleneck_encode: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not chain as (T, d) @ (d, d')")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return bottleneck_encode_plain(x, w, mn, mx, bits=bits)
    _build.require_cuda("bottleneck_encode", x, w)
    if x.dtype not in _FLOAT_CODES or w.dtype != x.dtype:
        raise TypeError(f"bottleneck_encode: x and w must share float32 or "
                        f"bfloat16, got {x.dtype} and {w.dtype}")
    _levels(bits)
    (t, d), dp = x.shape, w.shape[1]
    out = torch.empty((t, dp), dtype=code_dtype(bits), device=x.device)
    if out.numel() == 0:
        return out
    if d == 0:
        raise ValueError("bottleneck_encode: the contraction dim d is 0")
    lib = _build.library()
    _build.check(lib.repro_bottleneck_encode(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), t, d, dp,
        _FLOAT_CODES[x.dtype], bits, float(_f32(mn)), float(_f32(mx)),
        _build.stream_of(x)), "bottleneck_encode")
    _build.LAUNCHES["bottleneck_encode"] += 1
    return out
