"""Any-shape wrappers around the port's kernels, as ``src/repro/kernels/
ops.py``: flatten the leading dims, call the 2-D wrapper, reshape back
(``ssd_intra`` takes its 5-D layout as it is, made contiguous).

Which implementation runs follows the tensor's device only: the CUDA kernel
for a CUDA tensor, the plain PyTorch twin for a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bottleneck as _bn
from repro_torch.kernels import quant as _q
from repro_torch.kernels import ssd_intra as _ssd


def quantize(x, mn, mx, *, bits=8):
    """Any-shape fused quantization; returns integer codes of x.shape."""
    shape = x.shape
    return _q.quantize_2d(x.reshape(-1, shape[-1]), mn, mx, bits=bits).reshape(shape)


def dequantize(y, mn, mx, *, bits=8, out_dtype=torch.float32):
    """Inverse of :func:`quantize`."""
    shape = y.shape
    out = _q.dequantize_2d(y.reshape(-1, shape[-1]), mn, mx, bits=bits,
                           out_dtype=out_dtype)
    return out.reshape(shape)


def bottleneck_encode(x, w, mn, mx, *, bits=8):
    """Fused compressor encode. x: (..., d); w: (d, d')."""
    shape = x.shape
    out = _bn.bottleneck_encode(x.reshape(-1, shape[-1]), w, mn, mx, bits=bits)
    return out.reshape(shape[:-1] + (w.shape[1],))


def ssd_intra(xh, dt, la, Bm, Cm):
    """Mamba-2 SSD intra-chunk contribution (see kernels/ssd_intra.py)."""
    return _ssd.ssd_intra(*(t.contiguous() for t in (xh, dt, la, Bm, Cm)))
