"""GQA self-attention for train, prefill and decode
(``src/repro/models/attention.py``: ``_qkv``, ``_flash_inner``,
``_flash_decode`` and ``self_attention``).

Numerics follow the reference: the softmax scale multiplies q in q's dtype
before the dot; scores and the output accumulate in f32 (operands upcast,
which is exact for bf16); masked scores are -1e30; the probabilities are
cast to v's dtype before the second product; the output is cast back to
q's dtype. The reference chunks the KV axis (``attn_chunk``) only to bound
memory at long contexts; at this slice's lengths the whole (Sq, Sk) score
matrix fits, so the port computes it in one piece. It does not use
``scaled_dot_product_attention``, whose masking and rounding differ.

Decode (one token against the cache) goes through ``ops.decode_attention``
(the CUDA kernel on the card, its plain twin on the CPU), which computes
the reference's decode attention in f32: where the reference's
``_flash_decode`` rounds q * scale and the probabilities to a bf16 cache's
dtype, the kernel keeps them f32. The new token's k and v are written into
the cache in place (the reference returns an updated copy).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dtype_of, rms_head_norm

NEG_INF = -1e30


class Attention(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = dtype_of(cfg.param_dtype)
        p = lambda *shape: nn.Parameter(torch.empty(*shape, dtype=dt, device=device))
        self.cfg = cfg
        self.wq, self.wk, self.wv = p(d, hq * dh), p(d, hkv * dh), p(d, hkv * dh)
        self.wo = p(hq * dh, d)
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = p(hq * dh), p(hkv * dh), p(hkv * dh)
        if cfg.qk_norm:
            self.q_scale, self.k_scale = p(dh), p(dh)

    def forward(self, x, positions, *, causal=True, window=0):
        """Train-mode self-attention; x: (B, S, d) -> (B, S, d)."""
        return self_attention(self, x, self.cfg, positions, causal=causal,
                              window=window)[0]


def qkv(p, x, xc, cfg):
    """x: (B, S, d) query source; xc: kv source (x for self-attention).
    Returns q (B, S, Hq, D), k and v (B, Sk, Hkv, D), qk-normed per head."""
    b, s, _ = x.shape
    sk = xc.shape[1]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = x @ p.wq, xc @ p.wk, xc @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, hq, dh)
    k = k.reshape(b, sk, hkv, dh)
    v = v.reshape(b, sk, hkv, dh)
    if cfg.qk_norm:
        q = rms_head_norm(p.q_scale, q)
        k = rms_head_norm(p.k_scale, k)
    return q, k, v


def attention(q, k, v, *, q_positions, k_positions, causal=True, window=0):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); positions (B, S) int,
    k_positions -1 = invalid slot. Returns (B, Sq, Hq, D) in q's dtype."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    # the scale rounded to q's dtype first, as jnp.asarray(scale, q.dtype)
    scale = float(torch.tensor(dh ** -0.5, dtype=q.dtype))
    qf = (q.reshape(b, sq, hkv, g, dh) * scale).to(k.dtype)
    s = torch.einsum("bqhgd,bchd->bhgqc", qf.to(torch.float32),
                     k.to(torch.float32))                      # (B,Hkv,G,Sq,Sk)
    kp = k_positions[:, None, None, None, :]
    qp = q_positions[:, None, None, :, None]
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window:
        valid = valid & (kp > qp - window)
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1)
    acc = torch.einsum("bhgqc,bchd->bhgqd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    out = acc / torch.clamp(l, min=1e-20)[..., None]           # (B,Hkv,G,Sq,D)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh)
    return out.to(q.dtype)


def self_attention(p, x, cfg, positions, *, causal=True, window=0, kv_cache=None,
                   cache_slot=None, cache_positions=None, idx=None):
    """Self-attention for train/prefill (kv_cache None) or decode.

    Decode: x is one token (B, 1, d); kv_cache = {"k", "v"} each
    (B, L, Hkv, D); the new token's k/v are written at ``cache_slot`` (an
    int, already modulo L); cache_positions: (B, L) int32 slot ->
    absolute-position map (-1 invalid), already holding ``idx`` (an int,
    the token's position) at the slot.
    Returns (out (B, S, d), new_kv): the roped (k, v) to cache (prefill) or
    the updated cache {"k", "v"} (decode)."""
    q, k, v = qkv(p, x, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    b, s = q.shape[0], q.shape[1]
    if kv_cache is None:
        out = attention(q, k, v, q_positions=positions, k_positions=positions,
                        causal=causal, window=window)
        new_kv = (k, v)
    else:
        if cfg.kv_quant_bits:
            raise NotImplementedError("decode over a quantized cache (kv_quant_bits > 0) is "
                                      "not ported yet; it comes with a later model-zoo slice")
        if window:
            raise NotImplementedError("windowed (lattn) ring decode is not ported yet; it "
                                      "comes with the hybrid (RG-LRU) slice")
        ck, cv = kv_cache["k"], kv_cache["v"]
        ck[:, cache_slot] = k[:, 0]
        cv[:, cache_slot] = v[:, 0]
        out = ops.decode_attention(q[:, 0], ck, cv, cache_positions, idx)
        out = out.to(q.dtype)[:, None]
        new_kv = {"k": ck, "v": cv}
    return out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p.wo, new_kv
