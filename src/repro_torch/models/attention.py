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

Under a mesh (``meshctx``) self-attention is the program one rank runs
(``self_attention``'s docstring): ``wq``, ``wk``, ``wv`` column-parallel,
``wo`` row-parallel, and the KV cache held as ``cache_pspecs`` cuts it, its
length over "model" (merged through the kernel's log-sum-exp at decode,
``merge_lse``) or, where the length does not divide, its kv heads. Under
a sequence-parallel residual (``meshctx.seq_parallel``) the block hands
in its normed input gathered whole along the sequence, and ``wo``'s
partial sums are reduce-scattered along it (``scatter_seq``).

Cross-attention (the VLM's image layers, the encoder-decoder's decoder)
is the plain ``attention`` in every mode, as the reference's is its plain
``flash_attention``: no RoPE, every position 0, not causal; at decode it
reads the context's K/V from the cache. Under a mesh its projections are
cut as self-attention's, and its cache entry holds the rank's run of the
context (``pack_context``), over which a decode step attends with every
query head, the runs merged by the plain attention's log-sum-exp.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import meshctx, tp
from repro_torch.models.cache import pack_full_kv, quantize_kv
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
    Returns q (B, S, Hq, D), k and v (B, Sk, Hkv, D), qk-normed per head
    (under a mesh, the heads ``_heads`` holds)."""
    q, k, v, _ = _heads(p, x, cfg, xc)
    return q, k, v


def project_cross_kv(p, context, cfg):
    """k, v (B, Sc, Hkv, D) of ``context`` (B, Sc, d), qk-normed per head,
    not roped; under a mesh the kv heads ``_heads`` holds."""
    _, k, v, _ = _heads(p, None, cfg, context, query=False)
    return k, v


def attention(q, k, v, *, q_positions, k_positions, causal=True, window=0, chunk=1024,
              q_block=2048, return_lse=False):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); positions (B, S) int,
    k_positions -1 = invalid slot. Returns (B, Sq, Hq, D) in q's dtype;
    with ``return_lse`` (out in float32, each row's log-sum-exp (B, Sq, Hq)
    of its scaled, masked scores), as ``ops.decode_attention`` returns
    them, for ``merge_lse``. Query rows are independent, so blocks of
    ``q_block`` rows are computed one after another."""
    blocks = [_flash_inner(q[:, i:i + q_block], k, v, q_positions[:, i:i + q_block],
                           k_positions, causal, window, chunk, return_lse)
              for i in range(0, q.shape[1], q_block)]
    if len(blocks) == 1:
        return blocks[0]
    if return_lse:
        return tuple(torch.cat(parts, dim=1) for parts in zip(*blocks))
    return torch.cat(blocks, dim=1)


def _flash_inner(q, k, v, q_positions, k_positions, causal, window, chunk, return_lse=False):
    """Online softmax over key chunks: running max m, sum l and f32
    accumulator; a chunk's probabilities are cast to v's dtype before the
    second product. The first chunk sets (m, l, acc) directly: from the
    reference's (-1e30, 0, 0) its step gives the same values. With
    ``return_lse`` the output stays float32 and ``m + log l`` comes with it
    (a row with no valid key: -1e30, as the decode kernel gives it)."""
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
    if return_lse:
        return out, (m + torch.log(l)).permute(0, 3, 1, 2).reshape(b, sq, hq)
    return out.to(q.dtype)


def _gather_model(ts, dim, mesh):
    """Each of ``ts`` (this rank's blocks along ``dim``) whole over "model",
    in rank order, by one all-gather for each dtype and shape off ``dim``
    among them: the tensors of a kind are concatenated along ``dim`` and
    gathered on a new leading axis, then split apart."""
    out = [None] * len(ts)
    groups = {}
    for i, t in enumerate(ts):
        rest = tuple(n for j, n in enumerate(t.shape) if j != dim % t.dim())
        groups.setdefault((t.dtype, t.dim(), rest), []).append(i)
    for idxs in groups.values():
        parts = [ts[i] for i in idxs]
        if len(parts) == 1:
            out[idxs[0]] = mesh.all_gather(parts[0], "model", dim=dim)
            continue
        d = dim % parts[0].dim() + 1                      # dim on the gathered tensor
        g = mesh.all_gather(torch.cat(parts, dim).unsqueeze(0), "model", dim=0)
        at = 0
        for i, t in zip(idxs, parts):
            n = t.shape[dim]
            part = g.narrow(d, at, n).movedim(0, d - 1)       # (..., model, n, ...)
            out[i] = part.reshape(*part.shape[:d - 1], -1, *part.shape[d + 1:])
            at += n
    return out


def _heads(p, x, cfg, xc=None, *, query=True, kv=True):
    """q (B, S, H, D) of x, k and v (B, Sk, Hk, D) of ``xc`` (x where None)
    under the current mesh, and whether they hold this rank's heads only;
    q is None where ``query`` is False, k and v where ``kv`` is. Where
    "model" divides both the query and the kv heads and cuts all three
    projections (whichever are made), the rank keeps
    its heads (H = Hq / model, Hk = Hkv / model); elsewhere the projected
    columns it holds are all-gathered over "model" and it holds every
    head."""
    mesh = meshctx.get_mesh()
    m = tp.model_size(mesh)
    local = (m > 1 and all(tp.cols(w) for w in (p.wq, p.wk, p.wv))
             and cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0)
    xc = x if xc is None else xc
    names = ("q",) * query + ("k", "v") * kv
    outs = {}
    for n in names:
        y = (x if n == "q" else xc) @ tp.gather(getattr(p, "w" + n))
        outs[n] = y + getattr(p, "b" + n) if cfg.qkv_bias else y
    cut = [] if local else [n for n in names if tp.cols(getattr(p, "w" + n))]
    for n, y in zip(cut, _gather_model([outs[n] for n in cut], -1, mesh) if cut else []):
        outs[n] = y
    heads = {n: y.reshape(y.shape[0], y.shape[1], -1, cfg.head_dim) for n, y in outs.items()}
    if cfg.qk_norm:
        for n in ("q", "k"):
            if n in heads:
                heads[n] = rms_head_norm(getattr(p, n + "_scale"), heads[n])
    return heads.get("q"), heads.get("k"), heads.get("v"), local


def _out_proj(o, wo, local, scatter_seq=False):
    """o (B, S, heads held x D) through ``wo``: where ``wo``'s rows are
    cut over "model", the rank's rows (its own heads' columns of o) times
    its block, summed over "model"; else every head's columns times the
    whole ``wo``. With ``scatter_seq`` (o of the whole sequence under a
    sequence-parallel residual) the rank keeps its block of S / model
    positions of the product (``tp.row_out``)."""
    mesh = meshctx.get_mesh()
    if tp.rows(wo):
        if not local:
            o = o[..., tp.block_of(o.shape[-1], "model", mesh)]
    elif local:
        o = mesh.all_gather(o, "model", dim=-1)
    return tp.row_out(o, wo, scatter_seq)


def merge_lse(o, lse, mesh):
    """The decode outputs o (B, H, D) f32 of the ranks along "model", each
    over its run of cache slots, merged by their log-sum-exps lse (B, H):
    ``o = sum_r w_r o_r / sum_r w_r``, ``w_r = exp(lse_r - max_r lse_r)``,
    the reference's chunk merge (``_flash_decode``). Runs of equal length
    whose rows are all empty weigh alike, so such a row is the mean of v,
    as one run over all the slots gives it."""
    top = mesh.all_reduce(lse, "model", op="max")
    w = torch.exp(lse - top)[..., None]
    both = mesh.all_reduce(torch.cat([o * w, w], dim=-1), "model")
    return both[..., :-1] / both[..., -1:]


def pack_cache(k, v, positions, cache_len, *, window=0, kv_bits=0, local=False, cfg=None):
    """The layer's cache entry from the prefill's k, v (B, S, heads held,
    D), under the current mesh as ``cache_pspecs`` cuts it: with the length
    over "model" the rank's run of slots of every kv head (k, v gathered
    over "model" first where they hold the rank's heads only); with the kv
    heads over "model" its heads (and the int8 scales, which the rule keeps
    whole, gathered); without a mesh the whole entry (``pack_full_kv``)."""
    mesh = meshctx.get_mesh()
    m = tp.model_size(mesh)
    if m == 1:
        return pack_full_kv(k, v, positions, cache_len, window=window, kv_bits=kv_bits)
    lc = window if window else cache_len
    hkv = cfg.n_kv_heads
    if lc % m == 0:
        if local:
            k, v = _gather_model([k, v], 2, mesh)
        entry = pack_full_kv(k, v, positions, cache_len, window=window, kv_bits=kv_bits)
        sl = tp.block_of(lc, "model", mesh)
        return {name: t[:, sl].clone() for name, t in entry.items()}
    if hkv % m:
        raise ValueError(f"a cache of {lc} slots and {hkv} kv heads splits neither way over a "
                         f"model axis of {m}: give it a length the axis divides")
    if not local:
        sl = tp.block_of(hkv, "model", mesh)
        k, v = k[:, :, sl], v[:, :, sl]
    entry = pack_full_kv(k, v, positions, cache_len, window=window, kv_bits=kv_bits)
    if kv_bits:
        entry["k_scale"], entry["v_scale"] = _gather_model([entry["k_scale"],
                                                            entry["v_scale"]], 2, mesh)
    return entry


def _decode(p, cfg, q, k, v, local, cache, positions, idx, window):
    """One token's attention over the layer's (the rank's) cache entry (see
    ``self_attention``): returns (o (B, 1, heads held x D) in q's dtype,
    whether it holds the rank's heads only, the entry)."""
    mesh = meshctx.get_mesh()
    at_pos = positions[:, 0].to(cache["pos"].dtype)
    ck, cv, pos = cache["k"], cache["v"], cache["pos"]
    b, hkv, g = q.shape[0], cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    scaled = bool(cfg.kv_quant_bits)
    if scaled:
        kq, ksc = quantize_kv(k, cfg.kv_quant_bits)
        vq, vsc = quantize_kv(v, cfg.kv_quant_bits)
    else:
        kq, vq, ksc, vsc = k, v, None, None
    if ck.shape[2] < hkv:
        # kv heads over "model": the rank's heads attend to its whole-length cache
        hs = tp.block_of(hkv, "model", mesh)
        if not local:
            qs = tp.block_of(cfg.n_heads, "model", mesh)
            q, kq, vq = q[:, :, qs], kq[:, :, hs], vq[:, :, hs]
            if scaled:
                ksc, vsc = ksc[:, :, hs], vsc[:, :, hs]
        slot = idx % ck.shape[1]
        ck[:, slot], cv[:, slot] = kq[:, 0], vq[:, 0]
        pos[:, slot] = at_pos
        scales = {}
        if scaled:     # the rule keeps the scales whole: every rank writes every head's
            if ksc.shape[2] < hkv:
                ksc, vsc = _gather_model([ksc, vsc], 2, mesh)
            cache["k_scale"][:, slot] = ksc[:, 0]
            cache["v_scale"][:, slot] = vsc[:, 0]
            scales = {n: cache[n][:, :, hs] for n in ("k_scale", "v_scale")}
        o = ops.decode_attention(q[:, 0], ck, cv, pos, idx, window=window, **scales)
        return o.to(q.dtype)[:, None].reshape(b, 1, -1), True, cache
    # the length over "model" (or one run, without a mesh): the owner of slot
    # idx mod L writes the token (every kv head), every rank attends over its
    # run for every query head
    if local:
        if scaled:
            q, kq, vq, ksc, vsc = _gather_model([q, kq, vq, ksc, vsc], 2, mesh)
        else:
            q, kq, vq = _gather_model([q, kq, vq], 2, mesh)
    run, m = ck.shape[1], tp.model_size(mesh)
    slot = idx % (run * m)
    if m == 1 or slot // run == mesh.index("model"):
        at = slot % run
        ck[:, at], cv[:, at] = kq[:, 0], vq[:, 0]
        pos[:, at] = at_pos
        if scaled:
            cache["k_scale"][:, at], cache["v_scale"][:, at] = ksc[:, 0], vsc[:, 0]
    scales = {n: cache[n] for n in ("k_scale", "v_scale")} if scaled else {}
    if m == 1:
        o = ops.decode_attention(q[:, 0], ck, cv, pos, idx, window=window, **scales)
    else:
        o, lse = ops.decode_attention(q[:, 0], ck, cv, pos, idx, window=window,
                                      return_lse=True, **scales)
        o = merge_lse(o, lse, mesh)
    return o.to(q.dtype)[:, None].reshape(b, 1, hkv * g * cfg.head_dim), False, cache


def self_attention(p, x, cfg, positions, *, causal=True, window=0, cache=None, idx=None,
                   attn_len=0, prefill=False, scatter_seq=False):
    """Self-attention for train and prefill (``cache`` None; with
    ``prefill`` the layer's cache entry of ``attn_len`` slots is packed by
    ``pack_cache``) or decode: x is one token (B, 1, d) at position ``idx``
    (an int) against the layer's entry {"k", "v", "pos"} (B, L, Hkv, D),
    int8 codes with {"k_scale", "v_scale"} (B, L, Hkv) where
    ``cfg.kv_quant_bits``; the token's position, k and v (quantized, with
    their scales, as ``quantize_kv`` gives them) are written at slot ``idx
    mod L`` in place; ``window`` > 0 masks the positions at or before
    ``idx - window``. Returns (out (B, S, d), the entry; None in train
    mode).

    Under a mesh it is the program of one rank: the projections
    column-parallel and ``wo`` row-parallel (``_heads``, ``_out_proj``).
    At decode, with the cache's length over "model", a rank holds slots
    ``[r L/m, (r+1) L/m)`` of every kv head: only the rank owning slot
    ``idx mod L`` writes the token's k and v (gathered over "model" first
    where its heads do not cover them), every rank runs
    ``ops.decode_attention`` over its slots for all the query heads with
    the log-sum-exp, and ``merge_lse`` merges the ranks; with the kv heads
    over "model" each rank attends with its own heads and nothing is
    merged. With ``scatter_seq`` (train and prefill under a
    sequence-parallel residual: x and ``positions`` the whole sequence,
    gathered by the block) the projections, RoPE, the attention and the
    cache entry are as without it, and the output is the rank's block of
    S / model positions (``_out_proj``)."""
    q, k, v, local = _heads(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    b, s = q.shape[0], q.shape[1]
    if cache is None:
        out = attention(q, k, v, q_positions=positions, k_positions=positions,
                        causal=causal, window=window, chunk=cfg.attn_chunk)
        entry = (pack_cache(k, v, positions, attn_len, window=window,
                            kv_bits=cfg.kv_quant_bits, local=local, cfg=cfg)
                 if prefill else None)
        held = local
    else:
        out, held, entry = _decode(p, cfg, q, k, v, local, cache, positions, idx, window)
    return _out_proj(out.reshape(b, s, -1), p.wo, held, scatter_seq), entry


def cross_attention(p, x, cfg, *, kv=None, context=None, scatter_seq=False):
    """Cross-attention of x (B, S, d) over ``context`` (B, Sc, d), projected
    here, or over its precomputed ``kv`` = (k, v), each (B, Sc, Hkv, D).
    No RoPE; every query sees every context position. Gated by
    ``tanh(gate)`` where ``p`` has a gate. Returns (out (B, S, d), (k, v)).

    Under a mesh it is the program of one rank. From the context, q, k and
    v are its heads where "model" divides both head counts, else every head
    (``_heads``), and ``wo`` is row-parallel (``_out_proj``); the (k, v)
    returned hold those heads (``pack_context`` makes the cache entry of
    them). ``kv`` is the layer's cache entry as ``pack_context`` cut it:
    with its length over "model" every rank attends with every query head
    over its run of the context and the runs are merged by their
    log-sum-exps (``merge_lse``); with its kv heads over "model" the rank
    attends with its own heads. With ``scatter_seq`` (x the whole
    sequence under a sequence-parallel residual) the output is the rank's
    block of S / model positions (``_out_proj``), gated there: the gate is
    elementwise."""
    if kv is None:
        if context is None:
            raise ValueError("cross-attention needs its context: pass aux_embeds, the "
                             "(B, n_aux_tokens, d_model) frame or patch embeddings")
        q, k, v, held = _heads(p, x, cfg, context)
        out = _attend_all(q, k, v, cfg)
    else:
        k, v = kv
        out, held = _cross_decode(p, x, cfg, k, v)
    out = _out_proj(out.reshape(x.shape[0], x.shape[1], -1), p.wo, held, scatter_seq)
    if p.gate is not None:
        out = torch.tanh(p.gate.to(out.dtype)) * out
    return out, (k, v)


def _attend_all(q, k, v, cfg, return_lse=False):
    """``attention`` of q over every position of k and v (all at position
    0, not causal)."""
    b, s, dev = q.shape[0], q.shape[1], q.device
    return attention(q, k, v, q_positions=torch.zeros((b, s), dtype=torch.int32, device=dev),
                     k_positions=torch.zeros((b, k.shape[1]), dtype=torch.int32, device=dev),
                     causal=False, chunk=cfg.attn_chunk, return_lse=return_lse)


def _cross_decode(p, x, cfg, ck, cv):
    """x's attention over the layer's (the rank's) context cache ``ck``,
    ``cv``: (out (B, S, heads held, D) in x's dtype, whether it holds the
    rank's heads only)."""
    mesh = meshctx.get_mesh()
    m = tp.model_size(mesh)
    q, _, _, mine = _heads(p, x, cfg, kv=False)    # mine: q holds the rank's heads
    if m == 1:
        return _attend_all(q, ck, cv, cfg), False
    if ck.shape[2] < cfg.n_kv_heads:
        # kv heads over "model": the rank's heads attend to the whole context
        if not mine:
            q = q[:, :, tp.block_of(cfg.n_heads, "model", mesh)]
        return _attend_all(q, ck, cv, cfg), True
    # the length over "model": every query head over the rank's run, merged
    if mine:
        q = mesh.all_gather(q, "model", dim=2)
    o, lse = _attend_all(q, ck, cv, cfg, return_lse=True)
    return merge_lse(o, lse, mesh).to(q.dtype), False


def pack_context(k, v, cfg):
    """The cross-attention layer's cache entry {"ck", "cv"} of the
    context's k, v (B, Sc, heads held, D), under the current mesh as
    ``cache_pspecs`` cuts it: its length over "model" (the kv heads
    gathered over "model" first where k, v hold the rank's only), or where
    the length does not divide, its kv heads; without a mesh k and v."""
    mesh = meshctx.get_mesh()
    m = tp.model_size(mesh)
    if m == 1:
        return {"ck": k, "cv": v}
    sc, hkv = k.shape[1], cfg.n_kv_heads
    if sc % m == 0:
        if k.shape[2] < hkv:
            k, v = _gather_model([k, v], 2, mesh)
        sl = tp.block_of(sc, "model", mesh)
        return {"ck": k[:, sl].clone(), "cv": v[:, sl].clone()}
    if hkv % m:
        raise ValueError(f"a context of {sc} positions and {hkv} kv heads splits neither way "
                         f"over a model axis of {m}")
    if k.shape[2] == hkv:
        sl = tp.block_of(hkv, "model", mesh)
        k, v = k[:, :, sl].clone(), v[:, :, sl].clone()
    return {"ck": k, "cv": v}
