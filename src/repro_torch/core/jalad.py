"""JALAD baseline [Li et al., ICPADS'18], the port of
``src/repro/core/jalad.py``: 8-bit quantization plus entropy coding.

Only the compressed size enters the scheduling problem, so the entropy
coder is modelled information-theoretically: the coded size of the
quantized feature is its empirical byte entropy (the expected Huffman or
arithmetic code length). The histogram is ``torch.bincount``: exact
integer counts, so the entropy is the same on the card as on the CPU.
Quantization is ``core.compressor``'s plain Eq. 1-2, as the reference's;
no kernel runs here.
"""
from __future__ import annotations

import torch

from repro_torch.core.compressor import dequantize, quantize


def byte_entropy_bits(codes, bits=8):
    """Empirical entropy (bits a symbol) of quantized codes, a 0-d float32
    tensor."""
    hist = torch.bincount(codes.reshape(-1).long(), minlength=1 << bits).to(torch.float32)
    p = hist / torch.clamp(hist.sum(), min=1.0)
    return -torch.sum(torch.where(p > 0, p * torch.log2(torch.clamp(p, min=1e-30)), 0.0))


def jalad_compress_size_bits(feat, bits=8):
    """(estimated coded size in bits, rate against float32) of a feature
    map, both 0-d tensors."""
    codes, _, _ = quantize(feat, bits)
    h = byte_entropy_bits(codes, bits)
    return h * feat.numel(), 32.0 / torch.clamp(h, min=1e-6)


def jalad_roundtrip(feat, bits=8):
    codes, mn, mx = quantize(feat, bits)
    return dequantize(codes, bits, mn, mx).to(feat.dtype)


# entropy-coding throughput on the UE (symbols/s): JALAD's coder runs on the
# CPU, and this constant drives its (large) compression latency in the
# overhead model, the paper's Fig. 7 observation
ENTROPY_CODER_SYMBOLS_PER_S = 2.0e7
