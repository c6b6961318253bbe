"""Any-shape wrappers around the port's kernels, as ``src/repro/kernels/
ops.py``: flatten the leading dims, call the 2-D wrapper, reshape back
(``ssd_intra`` and ``decode_attention`` take their layouts as they are,
made contiguous), or unpack
the reference's parameter and observation dicts (``pair_scorer``,
``flat_trunk``).

Which implementation runs follows the tensor's device only: the CUDA kernel
for a CUDA tensor, the plain PyTorch twin for a CPU tensor, and the twin's
shapes and dtypes for a ``meta`` tensor (``_build.takes_twin``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bottleneck as _bn
from repro_torch.kernels import decode_attn as _da
from repro_torch.kernels import flat_trunk as _ft
from repro_torch.kernels import pair_scorer as _ps
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
    """Mamba-2 SSD intra-chunk contribution (see kernels/ssd_intra.py),
    differentiable (``ssd_intra.SsdIntra``: the forward and backward kernels
    on the card, the plain twin and formula on the CPU)."""
    return _ssd.SsdIntra.apply(*(t.contiguous() for t in (xh, dt, la, Bm, Cm)))


def decode_attention(q, k, v, pos, idx, *, k_scale=None, v_scale=None, window=0,
                     return_lse=False):
    """GQA flash-decode over a (ring) KV cache (see kernels/decode_attn.py).
    q: (B, Hq, D); k, v: (B, S, Hkv, D), float or int8 codes with k_scale,
    v_scale (B, S, Hkv); pos: (B, S) int32, -1 = empty; idx: int; window:
    int (0 = none). Returns (B, Hq, D) float32, and with ``return_lse`` each
    row's log-sum-exp (B, Hq) float32 beside it."""
    c = lambda t: None if t is None else t.contiguous()
    return _da.decode_attention(*(t.contiguous() for t in (q, k, v, pos)), idx,
                                k_scale=c(k_scale), v_scale=c(v_scale), window=window,
                                return_lse=return_lse)


def flat_trunk(rows, qlayers, *, bits=8):
    """Fused quantized trunk forward -> (..., W) float32 head columns.
    rows: (..., F) ``observe_per_ue`` rows; qlayers: the layer list of
    ``rl.distill.quantize_flat_trunk`` ([{"codes", "mn", "mx", "b"}, ...])."""
    shape = rows.shape
    out = _ft.flat_trunk(rows.reshape(-1, shape[-1]),
                         [l["codes"] for l in qlayers], [l["mn"] for l in qlayers],
                         [l["mx"] for l in qlayers], [l["b"] for l in qlayers], bits=bits)
    return out.reshape(shape[:-1] + (out.shape[-1],))


def pair_scorer(ue_emb, raw, srv_enc, scorer):
    """Fused entity route scorer -> (route_logits (..., N, E), srv_emb (...,
    E, S)), differentiable (``pair_scorer.PairScorer``: the forward and
    backward kernels on the card, their plain twins on the CPU). ue_emb:
    (..., N, d_ue); raw: the env's kernel-path block
    (``observe_entities_raw``: "d", "work", "active" (..., N), "geom" (...,
    E, 3), "consts" (..., 8)), whose leading axes (envs, minibatch samples)
    run as one launch, each env scored on its own; srv_enc: {"w", "b"};
    scorer: two {"w", "b"} layers. The env's constants are the same in
    every env: the first row is taken."""
    *lead, n, d_ue = ue_emb.shape
    flat = lambda t, k: t.expand(*lead, *t.shape[t.dim() - k:]).reshape(
        -1, *t.shape[t.dim() - k:])
    geom = flat(raw["geom"], 2)
    logits, srv = _ps.PairScorer.apply(
        ue_emb.reshape(-1, n, d_ue), flat(raw["d"], 1), flat(raw["work"], 1),
        flat(raw["active"], 1), geom, raw["consts"].reshape(-1, _ps.N_CONSTS)[0],
        srv_enc["w"], srv_enc["b"], scorer[0]["w"], scorer[0]["b"], scorer[1]["w"],
        scorer[1]["b"])
    return logits.reshape(*lead, n, geom.shape[-2]), srv.reshape(*lead, *srv.shape[-2:])
