"""Plain PyTorch oracles for the port's kernels, mirroring
``src/repro/kernels/ref.py`` op for op (including where it does its
scalar arithmetic in Python, before the range reaches float32)."""
from __future__ import annotations

import torch


def code_dtype(bits: int) -> torch.dtype:
    return torch.uint8 if bits <= 8 else torch.uint16


def quantize_ref(x, mn, mx, bits=8):
    """Linear min-max quantization (paper Eq. 1) with static calibration."""
    levels = (1 << bits) - 1
    scale = levels / torch.clamp(torch.as_tensor(mx - mn, dtype=torch.float32),
                                 min=1e-12)
    y = torch.clamp(torch.round((x.to(torch.float32) - mn) * scale), 0, levels)
    return y.to(code_dtype(bits))


def dequantize_ref(y, mn, mx, bits=8):
    """Paper Eq. 2."""
    levels = (1 << bits) - 1
    return y.to(torch.float32) * (mx - mn) / levels + mn


def bottleneck_encode_ref(x, w, mn, mx, bits=8):
    """Fused compressor encode: (T, d) @ (d, d') then quantize."""
    z = x.to(torch.float32) @ w.to(torch.float32)
    return quantize_ref(z, mn, mx, bits)


def ssd_intra_ref(xh, dt, la, Bm, Cm):
    """SSD intra-chunk oracle (mirrors models/ssm.ssd_chunked's intra part).
    xh: (B, NC, Q, H, P); dt, la: (B, NC, Q, H); Bm, Cm: (B, NC, Q, N)."""
    q = xh.shape[2]
    seg = la[:, :, :, None, :] - la[:, :, None, :, :]   # (B,NC,i,j,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=la.device))
    seg = torch.where(mask[None, None, :, :, None], seg, -1e30)
    cb = torch.einsum("bcin,bcjn->bcij", Cm, Bm)
    w = cb[..., None] * torch.exp(seg) * dt[:, :, None, :, :]
    return torch.einsum("bcijh,bcjhp->bcihp", w, xh)


def decode_attention_ref(q, k, v, pos, idx, *, k_scale=None, v_scale=None, window=0,
                         return_lse=False):
    """GQA decode attention over a (ring) KV cache.

    q: (B, Hq, D) single query token; k, v: (B, S, Hkv, D) floats, or int8
    codes with k_scale, v_scale (B, S, Hkv): a slot's scores are multiplied
    by its k_scale and its probabilities, after the softmax's sum, by its
    v_scale (the reference model's ``_flash_decode``);
    pos: (B, S) absolute positions (-1 = empty slot); idx: scalar int;
    window > 0 also masks ``pos <= idx - window``.
    Returns (B, Hq, D) f32 (float64 for float64 inputs, so the kernel can be
    held to an exact version of the same function); with ``return_lse`` also
    each row's log-sum-exp of its scores (B, Hq), before the v-scales (an
    empty row's is -1e30 + log S)."""
    wide = lambda t: t.to(torch.promote_types(t.dtype, torch.float32))
    b, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qf = wide(q).reshape(b, hkv, g, d) * (d ** -0.5)
    s = torch.einsum("bhgd,bshd->bhgs", qf, wide(k))
    if k_scale is not None:
        s = s * wide(k_scale).permute(0, 2, 1)[:, :, None, :]
    valid = (pos >= 0) & (pos <= idx)
    if window:
        valid = valid & (pos > idx - window)
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * wide(v_scale).permute(0, 2, 1)[:, :, None, :]
    o = torch.einsum("bhgs,bshd->bhgd", p, wide(v)).reshape(b, hq, d)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(b, hq)


def flat_trunk_ref(x, codes, mns, mxs, bs, bits=8):
    """Oracle of the quantized dispatch trunk: dequantize every layer with
    ``dequantize_ref`` (float32 range), then the tanh MLP, linear last."""
    f32 = torch.float32
    h = x.to(f32)
    for i in range(len(codes)):
        w = dequantize_ref(codes[i], torch.tensor(float(mns[i]), dtype=f32),
                           torch.tensor(float(mxs[i]), dtype=f32), bits).to(h.device)
        h = h @ w + torch.as_tensor(bs[i], dtype=f32, device=h.device)
        if i < len(codes) - 1:
            h = torch.tanh(h)
    return h


def pair_scorer_ref(ue_emb, d, work, active, geom, consts,
                    w_srv, b_srv, w1, b1, w2, b2):
    """Oracle of the fused pair scorer, mirroring the default entity path:
    the (N, E, 3) edge tensor of ``observe_entities``, then the
    materialized (N, E, d_ue+S+3) pair concat through the scorer MLP.
    Returns (route_logits (N, E), srv_emb (E, S))."""
    f = lambda t: t.to(torch.float32)
    ue_emb, d, work, active, geom, consts = map(f, (ue_emb, d, work, active, geom, consts))
    w_srv, b_srv, w1, b1, w2, b2 = map(f, (w_srv, b_srv, w1, b1, w2, b2))
    n, d_ue = ue_emb.shape
    e = geom.shape[0]
    per_slot = active.sum() / consts[5]
    srv_rows = torch.cat([
        geom * torch.stack([torch.ones_like(consts[7]), torch.ones_like(consts[7]), consts[7]]),
        per_slot.broadcast_to((e,))[:, None],
    ], dim=1)
    srv = torch.tanh(srv_rows @ w_srv + b_srv)
    dist_ne = d[:, None] * geom[None, :, 0]
    g_ne = torch.pow(torch.clamp(dist_ne, min=1.0), -consts[0])
    rate = (geom[:, 1] * consts[3])[None, :] * torch.log2(1.0 + consts[1] * g_ne / consts[2])
    te = work[:, None] * geom[None, :, 2] / consts[4]
    edge = torch.stack([dist_ne / consts[6], rate, te], dim=-1)
    pair = torch.cat([
        ue_emb[:, None, :].expand(n, e, d_ue),
        srv[None, :, :].expand(n, e, srv.shape[-1]),
        edge,
    ], dim=-1)
    h = torch.tanh(pair @ w1 + b1)
    return (h @ w2 + b2)[..., 0], srv
