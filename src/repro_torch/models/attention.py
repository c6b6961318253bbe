"""GQA self-attention for train, prefill and decode, and cross-attention
(``src/repro/models/attention.py``: ``_qkv``, ``_flash_inner``,
``_flash_decode``, ``self_attention``, ``cross_attention`` and
``project_cross_kv``).

Numerics follow the reference: the softmax scale multiplies q in q's dtype
before the dot; scores and the output accumulate in f32 (operands upcast,
which is exact for bf16); masked scores are -1e30; the probabilities are
cast to v's dtype before the second product; the output is cast back to
q's dtype. Train and prefill attention is the reference's ``_flash_inner``:
an online softmax over key chunks of ``attn_chunk`` (the last one padded
with invalid slots, as the reference pads it), in query blocks of 2048
when Sq is longer, so memory is O(q_block * chunk) per head rather than
O(Sq * Sk). It does not use ``scaled_dot_product_attention``, whose masking
and rounding differ.

Decode (one token against the cache) goes through ``ops.decode_attention``
(the CUDA kernel on the card, its plain twin on the CPU), which computes
the reference's decode attention in f32, over a float or an int8 cache
(``kv_quant_bits``: codes with per-(slot, kv head) scales) and with or
without a window: where the reference's ``_flash_decode`` rounds q * scale
and the probabilities to a bf16 cache's (or an int8 cache's q's) dtype,
the kernel keeps them f32. The new token's k and v (or their codes and
scales) are written into the cache in place (the reference returns an
updated copy).

Cross-attention (the VLM's image layers, the encoder-decoder's decoder)
is the plain ``attention`` in every mode, as the reference's is its plain
``flash_attention``: no RoPE, every position 0, not causal; at decode it
reads the context's K/V from the cache.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.cache import quantize_kv
from repro_torch.models.layers import apply_rope, dtype_of, rms_head_norm

NEG_INF = -1e30


class Attention(nn.Module):
    """The projections of one attention layer; ``cross`` adds the VLM's
    scalar ``gate`` (zero at init), through which ``cross_attention`` scales
    its output by ``tanh(gate)``."""

    def __init__(self, cfg, *, cross=False, device=None):
        super().__init__()
        d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = dtype_of(cfg.param_dtype)
        p = lambda *shape: nn.Parameter(torch.empty(shape, dtype=dt, device=device))
        self.cfg = cfg
        self.wq, self.wk, self.wv = p(d, hq * dh), p(d, hkv * dh), p(d, hkv * dh)
        self.wo = p(hq * dh, d)
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = p(hq * dh), p(hkv * dh), p(hkv * dh)
        if cfg.qk_norm:
            self.q_scale, self.k_scale = p(dh), p(dh)
        self.gate = p() if cross else None

    def forward(self, x, positions, *, causal=True, window=0):
        """Train-mode self-attention; x: (B, S, d) -> (B, S, d)."""
        return self_attention(self, x, self.cfg, positions, causal=causal,
                              window=window)[0]


def qkv(p, x, xc, cfg):
    """x: (B, S, d) query source; xc: kv source (x for self-attention).
    Returns q (B, S, Hq, D), k and v (B, Sk, Hkv, D), qk-normed per head."""
    k, v = project_cross_kv(p, xc, cfg)
    return query(p, x, cfg), k, v


def query(p, x, cfg):
    """q (B, S, Hq, D) of x (B, S, d), qk-normed per head."""
    b, s, _ = x.shape
    q = x @ p.wq
    if cfg.qkv_bias:
        q = q + p.bq
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    return rms_head_norm(p.q_scale, q) if cfg.qk_norm else q


def project_cross_kv(p, context, cfg):
    """k, v (B, Sc, Hkv, D) of ``context`` (B, Sc, d), qk-normed per head,
    not roped."""
    b, sk, _ = context.shape
    k, v = context @ p.wk, context @ p.wv
    if cfg.qkv_bias:
        k, v = k + p.bk, v + p.bv
    k = k.reshape(b, sk, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, sk, cfg.n_kv_heads, cfg.head_dim)
    return (rms_head_norm(p.k_scale, k) if cfg.qk_norm else k), v


def attention(q, k, v, *, q_positions, k_positions, causal=True, window=0, chunk=1024,
              q_block=2048):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); positions (B, S) int,
    k_positions -1 = invalid slot. Returns (B, Sq, Hq, D) in q's dtype.
    Query rows are independent, so blocks of ``q_block`` rows are computed
    one after another."""
    blocks = [_flash_inner(q[:, i:i + q_block], k, v, q_positions[:, i:i + q_block],
                           k_positions, causal, window, chunk)
              for i in range(0, q.shape[1], q_block)]
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)


def _flash_inner(q, k, v, q_positions, k_positions, causal, window, chunk):
    """Online softmax over key chunks: running max m, sum l and f32
    accumulator; a chunk's probabilities are cast to v's dtype before the
    second product. The first chunk sets (m, l, acc) directly: from the
    reference's (-1e30, 0, 0) its step gives the same values."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    # the scale rounded to q's dtype first, as jnp.asarray(scale, q.dtype)
    scale = float(torch.tensor(dh ** -0.5, dtype=q.dtype))
    qf = (q.reshape(b, sq, hkv, g, dh) * scale).to(k.dtype).to(torch.float32)
    qp = q_positions[:, None, None, :, None]
    chunk = min(chunk, sk)
    m = l = acc = None
    for c0 in range(0, sk, chunk):
        kb, vb, pb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk], k_positions[:, c0:c0 + chunk]
        pad = chunk - kb.shape[1]
        if pad:     # the reference pads the last chunk with zeros at position -1
            kb = torch.nn.functional.pad(kb, (0, 0, 0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, pad))
            pb = torch.nn.functional.pad(pb, (0, pad), value=-1)
        s = torch.einsum("bqhgd,bchd->bhgqc", qf, kb.to(torch.float32))   # (B,Hkv,G,Sq,C)
        kp = pb[:, None, None, None, :]
        valid = kp >= 0
        if causal:
            valid = valid & (kp <= qp)
        if window:
            valid = valid & (kp > qp - window)
        s = s.masked_fill(~valid, NEG_INF)
        m_new = s.amax(-1) if m is None else torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        pv = torch.einsum("bhgqc,bchd->bhgqd", p.to(vb.dtype).to(torch.float32),
                          vb.to(torch.float32))
        if m is None:
            l, acc = p.sum(-1), pv
        else:
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]           # (B,Hkv,G,Sq,D)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh)
    return out.to(q.dtype)


def self_attention(p, x, cfg, positions, *, causal=True, window=0, kv_cache=None,
                   cache_slot=None, cache_positions=None, idx=None):
    """Self-attention for train/prefill (kv_cache None) or decode.

    Decode: x is one token (B, 1, d); kv_cache = {"k", "v"} each
    (B, L, Hkv, D), int8 codes with {"k_scale", "v_scale"} (B, L, Hkv)
    where ``cfg.kv_quant_bits``; the new token's k/v (quantized, with their
    scales, as ``quantize_kv`` gives them) are written at ``cache_slot``
    (an int, already modulo L); cache_positions: (B, L) int32 slot ->
    absolute-position map (-1 invalid), already holding ``idx`` (an int,
    the token's position) at the slot; ``window`` > 0 masks the positions
    at or before ``idx - window``.
    Returns (out (B, S, d), new_kv): the roped (k, v) to cache (prefill) or
    the updated cache {"k", "v"(, "k_scale", "v_scale")} (decode)."""
    q, k, v = qkv(p, x, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    b, s = q.shape[0], q.shape[1]
    if kv_cache is None:
        out = attention(q, k, v, q_positions=positions, k_positions=positions,
                        causal=causal, window=window, chunk=cfg.attn_chunk)
        new_kv = (k, v)
    else:
        ck, cv = kv_cache["k"], kv_cache["v"]
        scales = {}
        if cfg.kv_quant_bits:
            # the token's codes and per-(token, kv head) scales, in place
            kq, ksc = quantize_kv(k, cfg.kv_quant_bits)
            vq, vsc = quantize_kv(v, cfg.kv_quant_bits)
            ck[:, cache_slot], cv[:, cache_slot] = kq[:, 0], vq[:, 0]
            kv_cache["k_scale"][:, cache_slot] = ksc[:, 0]
            kv_cache["v_scale"][:, cache_slot] = vsc[:, 0]
            scales = {"k_scale": kv_cache["k_scale"], "v_scale": kv_cache["v_scale"]}
        else:
            ck[:, cache_slot] = k[:, 0]
            cv[:, cache_slot] = v[:, 0]
        out = ops.decode_attention(q[:, 0], ck, cv, cache_positions, idx, window=window,
                                   **scales)
        out = out.to(q.dtype)[:, None]
        new_kv = dict({"k": ck, "v": cv}, **scales)
    return out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p.wo, new_kv


def cross_attention(p, x, cfg, *, kv=None, context=None):
    """Cross-attention of x (B, S, d) over ``context`` (B, Sc, d), projected
    here, or over its precomputed ``kv`` = (k, v), each (B, Sc, Hkv, D).
    No RoPE; every query sees every context position. Gated by
    ``tanh(gate)`` where ``p`` has a gate. Returns (out (B, S, d), (k, v))."""
    if kv is None:
        if context is None:
            raise ValueError("cross-attention needs its context: pass aux_embeds, the "
                             "(B, n_aux_tokens, d_model) frame or patch embeddings")
        k, v = project_cross_kv(p, context, cfg)
    else:
        k, v = kv
    b, s, _ = x.shape
    hq, dh = cfg.n_heads, cfg.head_dim
    q = query(p, x, cfg)
    qpos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    kpos = torch.zeros((b, k.shape[1]), dtype=torch.int32, device=x.device)
    out = attention(q, k, v, q_positions=qpos, k_positions=kpos, causal=False,
                    chunk=cfg.attn_chunk)
    out = out.reshape(b, s, hq * dh) @ p.wo
    if p.gate is not None:
        out = torch.tanh(p.gate.to(out.dtype)) * out
    return out, (k, v)

