"""Autoencoder-based intermediate feature compression (paper §2), the
serving half of ``src/repro/core/compressor.py``.

The encoder and decoder are single 1x1 convolutions over the channel dim:
an einsum over C for CNN features (B, C, H, W) and a d -> d' matmul for
transformer hidden states (B, S, d). Quantization is linear min-max to
``bits`` bits (Eq. 1-2); the overall rate is R = (ch * 32) / (ch' * bits)
(Eq. 3). These functions are plain tensor code; the fused, kernel-backed
encode is ``repro_torch.kernels.ops.bottleneck_encode``. The two-stage CNN
training of the reference comes with the CNN slice.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.ref import code_dtype


def quantize(x, bits, minv=None, maxv=None):
    """Eq. 1. Returns (codes, minv, maxv); codes are integers in
    [0, 2^bits - 1] in the smallest sufficient unsigned dtype."""
    minv = x.min() if minv is None else minv
    maxv = x.max() if maxv is None else maxv
    levels = (1 << bits) - 1
    scale = levels / torch.clamp(torch.as_tensor(maxv - minv), min=1e-12)
    y = torch.clamp(torch.round((x - minv) * scale), 0, levels)
    return y.to(code_dtype(bits)), minv, maxv


def dequantize(y, bits, minv, maxv):
    """Eq. 2."""
    levels = (1 << bits) - 1
    return y.to(torch.float32) * (maxv - minv) / levels + minv


def compression_rate(ch, ch_prime, bits):
    """Eq. 3: R = R_c * R_q."""
    return (ch * 32.0) / (ch_prime * bits)


def init_autoencoder(generator, ch, ch_prime, *, device=None):
    """Random AE: enc (ch, ch') ~ N(0, 1/ch), dec (ch', ch) ~ N(0, 1/ch')."""
    enc = torch.randn((ch, ch_prime), generator=generator, device=device)
    dec = torch.randn((ch_prime, ch), generator=generator, device=device)
    return {"enc": enc / math.sqrt(ch), "dec": dec / math.sqrt(ch_prime)}


def pca_init_autoencoder(feats, ch_prime):
    """Closed-form optimal linear AE: the top principal components of the
    boundary features. feats: (B, C, H, W) (samples over B*H*W) or (..., C)
    channel-last (samples over all leading axes). The sign of each
    component is whatever the SVD returns."""
    if feats.dim() == 4:
        f = torch.movedim(feats, 1, -1).reshape(-1, feats.shape[1])
    else:
        f = feats.reshape(-1, feats.shape[-1])
    mu = f.mean(0)
    _, _, vt = torch.linalg.svd(f - mu, full_matrices=False)
    pcs = vt[:ch_prime].T.contiguous()
    return {"enc": pcs, "dec": pcs.T.contiguous()}


def encode(ae, feat):
    """feat: (B, C, H, W) or (B, S, C) -> bottleneck along the channel dim."""
    if feat.dim() == 4:
        return torch.einsum("bchw,cd->bdhw", feat, ae["enc"])
    return feat @ ae["enc"]


def decode(ae, z):
    if z.dim() == 4:
        return torch.einsum("bdhw,dc->bchw", z, ae["dec"])
    return z @ ae["dec"]


def roundtrip(ae, feat, bits=None):
    """encode -> (optional quantize/dequantize) -> decode."""
    z = encode(ae, feat)
    if bits is not None:
        q, mn, mx = quantize(z, bits)
        z = dequantize(q, bits, mn, mx).to(feat.dtype)
    return decode(ae, z)
