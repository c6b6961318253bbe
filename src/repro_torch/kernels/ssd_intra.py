"""Mamba-2 SSD intra-chunk term,
``y[i] = sum_{j<=i} (C_i . B_j) * exp(la_i - la_j) * dt_j * x_j``.

Replaces ``src/repro/kernels/ssd_intra.py::ssd_intra`` (Pallas TPU), the
quadratic hot spot of ``models/ssm.ssd_chunked``. On a CUDA tensor the
wrapper launches the hand-written SIMT kernels of ``csrc/ssd_intra.cu`` (the
lower triangle of the chunk's Gram matrix C B^T into an L2-resident
scratch, then 64-row output tiles that walk only the column tiles on or
below the diagonal, f32 FMA accumulation) or raises. It is bound by
operations on the H100; tensor cores are not used, since TF32 misses the
reference's 1e-5 tolerance. On a CPU tensor the wrapper runs the plain twin.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant import _FLOAT_CODES
from repro_torch.kernels.ref import ssd_intra_ref


def ssd_intra_plain(xh, dt, la, Bm, Cm):
    """The kernel's function in plain PyTorch: the reference's einsum form,
    in float32."""
    f = lambda t: t.to(torch.float32)
    return ssd_intra_ref(f(xh), f(dt), f(la), f(Bm), f(Cm))


def ssd_intra(xh, dt, la, Bm, Cm):
    """xh: (B, NC, Q, H, P) float32 or bfloat16; dt, la: (B, NC, Q, H)
    float32; Bm, Cm: (B, NC, Q, N), both float32 or both bfloat16. Returns
    y_intra (B, NC, Q, H, P) float32."""
    if xh.dim() != 5 or dt.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"ssd_intra: expected xh (B, NC, Q, H, P), dt/la (B, NC, Q, H) "
                         f"and Bm/Cm (B, NC, Q, N), got {tuple(xh.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(Bm.shape)}")
    b, nc, q, h, p = xh.shape
    n = Bm.shape[-1]
    if (dt.shape != (b, nc, q, h) or la.shape != dt.shape
            or Bm.shape[:3] != (b, nc, q) or Cm.shape != Bm.shape):
        raise ValueError(f"ssd_intra: shapes do not agree: xh {tuple(xh.shape)}, "
                         f"dt {tuple(dt.shape)}, la {tuple(la.shape)}, "
                         f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    tensors = (xh, dt, la, Bm, Cm)
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_intra_plain(*tensors)
    _build.require_cuda("ssd_intra", *tensors)
    if dt.dtype != torch.float32 or la.dtype != torch.float32:
        raise TypeError(f"ssd_intra: dt and la must be float32, got {dt.dtype} and {la.dtype}")
    if xh.dtype not in _FLOAT_CODES or Bm.dtype not in _FLOAT_CODES or Cm.dtype != Bm.dtype:
        raise TypeError(f"ssd_intra: xh must be float32 or bfloat16 and Bm, Cm share one "
                        f"of them, got {xh.dtype}, {Bm.dtype} and {Cm.dtype}")
    out = torch.empty((b, nc, q, h, p), dtype=torch.float32, device=xh.device)
    if out.numel() == 0:
        return out
    if n == 0:
        raise ValueError("ssd_intra: the state dim N is 0")
    gram = torch.empty((b * nc, q, q), dtype=torch.float32, device=xh.device)
    lib = _build.library()
    _build.check(lib.repro_ssd_intra(
        xh.data_ptr(), dt.data_ptr(), la.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        gram.data_ptr(), out.data_ptr(), b * nc, q, h, p, n,
        _FLOAT_CODES[xh.dtype], _FLOAT_CODES[Bm.dtype], _build.stream_of(xh)), "ssd_intra")
    _build.LAUNCHES["ssd_intra"] += 1
    return out
