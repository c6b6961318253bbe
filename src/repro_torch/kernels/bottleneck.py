"""Fused compressor encode, ``codes = quantize(x @ W_enc)`` (paper Eq. 1).

Replaces ``src/repro/kernels/bottleneck.py::bottleneck_encode`` (Pallas
TPU): the whole UE-side cost of the compressor for transformer hidden
states. On a CUDA tensor the wrapper launches a hand-written kernel of
``csrc/bottleneck.cu`` or raises; on a CPU tensor it runs the plain twin.

The kernel is chosen by shape and address before the launch (``route``):

* ``"mma"``, every shape whose d and d' are multiples of 4 with x and w
  aligned to four elements (both serving shapes): the tensor cores in
  3xTF32 (each f32 operand split into TF32 high and low parts, three
  ``mma.sync`` products summed in f32; bf16 inputs, exact in TF32, take
  one), 128 x 64 output tiles, a 3-stage ``cp.async`` ring, K split over a
  thread block cluster of ``plan_split`` blocks so the grid fills the card
  in one wave, and the quantize as its epilogue, so z never reaches memory;
* ``"simt"``, anything else: a SIMT f32-FMA tile with element-wise loads.

Both are bound by operations on the H100; both sum in f32, so codes stay
within one of the twin's at 16 bits.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant import _FLOAT_CODES, _f32, _levels, quantize_plain
from repro_torch.kernels.ref import code_dtype

BM, BN, BK, STAGES = 128, 64, 64, 3    # the tensor-core kernel's tile and ring
MAX_SPLIT = 4                          # its blocks of a cluster along K
CHUNK = 4                              # elements a cp.async moves


def bottleneck_encode_plain(x, w, mn, mx, *, bits=8):
    """The kernel's function in plain PyTorch: an f32 matmul, then Eq. 1."""
    z = x.to(torch.float32) @ w.to(torch.float32)
    return quantize_plain(z, mn, mx, bits=bits)


def route(x, w) -> str:
    """``"mma"`` (tensor cores) where d and d' are multiples of 4 and x and
    w start on a four-element boundary, else ``"simt"``."""
    align = CHUNK * x.element_size()
    ok = (x.shape[1] % CHUNK == 0 and w.shape[1] % CHUNK == 0
          and x.data_ptr() % align == 0 and w.data_ptr() % align == 0)
    return "mma" if ok else "simt"


def plan_split(t, d, dp, n_sm):
    """Blocks of a cluster along K: doubled (up to MAX_SPLIT) while twice
    the blocks still fit in ``n_sm`` and each block keeps at least a ring's
    worth of K tiles. (1024, 2048) @ (2048, 512) on 132 SMs: 64
    tiles x 2; at T = 2048: 128 tiles x 1."""
    tiles = math.ceil(t / BM) * math.ceil(dp / BN)
    k_tiles = math.ceil(d / BK)
    split = 1
    while (split < MAX_SPLIT and 2 * split * tiles <= n_sm
           and k_tiles >= 2 * split * STAGES):
        split *= 2
    return split


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
    mma = route(x, w) == "mma"
    split = plan_split(t, d, dp, _build.sm_count(x.device)) if mma else 1
    lib = _build.library()
    _build.check(lib.repro_bottleneck_encode(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), t, d, dp,
        _FLOAT_CODES[x.dtype], bits, float(_f32(mn)), float(_f32(mx)), int(mma), split,
        _build.stream_of(x)), "bottleneck_encode")
    _build.LAUNCHES["bottleneck_encode"] += 1
    return out
