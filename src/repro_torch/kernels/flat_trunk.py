"""Fused dequantize-and-MLP forward of the distilled dispatch trunk.

Replaces ``src/repro/kernels/flat_trunk.py::flat_trunk_pallas`` (Pallas
TPU). Per layer: dequantize the weight codes,
``w = codes * ((mx - mn) / levels) + mn`` (paper Eq. 2), then
``h @ w + b``, tanh between layers, linear last. The float32 weights
never reach device memory.

On a CUDA tensor the wrapper launches the hand-written kernel of
``csrc/flat_trunk.cu`` (8 rows per block; each block dequantizes every
layer into shared memory with the same two roundings as the plain twin,
so the dequantized weights are bit-equal to it, then runs the f32 FMA
chain) or raises. The layer count and widths travel in a descriptor, so
any trunk depth (up to ``MAX_LAYERS``) and width takes the same kernel.
At the serving size (a few thousand rows) it is bound by launch latency:
2 M 6144 FLOP is 13 MFLOP at M = 1024. On a CPU tensor the wrapper runs
the plain twin.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant import _levels
from repro_torch.kernels.ref import code_dtype

MAX_LAYERS = 8


def dequantized_weights(codes, mn, mx, *, bits=8):
    """One layer's float32 weights with the kernel's association,
    ``codes * ((mx - mn) / levels) + mn``, every step rounded to float32."""
    mn, mx = np.float32(mn), np.float32(mx)
    step = (mx - mn) / _levels(bits)
    return codes.to(torch.float32) * float(step) + float(mn)


def flat_trunk_plain(x, codes, mns, mxs, bs, *, bits=8):
    """The kernel's function in plain PyTorch (the association of
    ``flat_trunk_xla``)."""
    h = x.to(torch.float32)
    for i in range(len(codes)):
        w = dequantized_weights(codes[i], mns[i], mxs[i], bits=bits)
        h = h @ w + bs[i].to(torch.float32)
        if i < len(codes) - 1:
            h = torch.tanh(h)
    return h


def flat_trunk(x, codes, mns, mxs, bs, *, bits=8):
    """x: (M, F) float rows; codes: per-layer (nin_i, nout_i) weight codes
    (uint8 for bits <= 8, else uint16) chaining F -> ... -> W; mns, mxs:
    per-layer float32 calibration scalars (host values); bs: per-layer
    (nout_i,) biases. Returns (M, W) float32."""
    n_layers = len(codes)
    if x.dim() != 2 or n_layers == 0 or not (len(mns) == len(mxs) == len(bs) == n_layers):
        raise ValueError(f"flat_trunk: x must be (M, F) and every layer needs codes, "
                         f"mn, mx and b; got x {tuple(x.shape)} and {n_layers} layers")
    dims = [x.shape[1]] + [c.shape[1] for c in codes]
    for i, c in enumerate(codes):
        if c.dim() != 2 or c.shape[0] != dims[i] or bs[i].shape != (dims[i + 1],):
            raise ValueError(f"flat_trunk: layer {i} codes {tuple(c.shape)} and bias "
                             f"{tuple(bs[i].shape)} do not chain from width {dims[i]}")
    tensors = (x, *codes, *bs)
    if all(t.device.type == "cpu" for t in tensors):
        return flat_trunk_plain(x, codes, mns, mxs, bs, bits=bits)
    x = x.to(torch.float32).contiguous()
    bs = [b.to(torch.float32).contiguous() for b in bs]
    _build.require_cuda("flat_trunk", x, *codes, *bs)
    _levels(bits)
    if n_layers > MAX_LAYERS:
        raise ValueError(f"flat_trunk: at most {MAX_LAYERS} layers, got {n_layers}")
    for c in codes:
        if c.dtype != code_dtype(bits):
            raise TypeError(f"flat_trunk: {bits}-bit codes must be {code_dtype(bits)}, "
                            f"got {c.dtype}")
    out = torch.empty((x.shape[0], dims[-1]), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    _build.check(lib.repro_flat_trunk(
        x.data_ptr(), out.data_ptr(), x.shape[0], n_layers,
        (ctypes.c_int * (n_layers + 1))(*dims),
        (ctypes.c_void_p * n_layers)(*(c.data_ptr() for c in codes)),
        (ctypes.c_void_p * n_layers)(*(b.data_ptr() for b in bs)),
        (ctypes.c_float * n_layers)(*(float(np.float32(v)) for v in mns)),
        (ctypes.c_float * n_layers)(*(float(np.float32(v)) for v in mxs)),
        bits, _build.stream_of(x)), "flat_trunk")
    _build.LAUNCHES["flat_trunk"] += 1
    return out
