"""Serving caches of the port (``src/repro/models/cache.py``): full and
ring-buffer KV caches (a ``"lattn"`` layer's ring holds ``cfg.window``
slots; a ``"moe"`` layer's is a dense layer's), the Mamba-2 state, the
RG-LRU state, and the context's K/V of the cross-attention layers (an
``"xattn"`` layer's ``ck``, ``cv`` over the ``n_aux_tokens`` image
patches; a ``"decx"`` layer's dense entry plus ``ck``, ``cv`` over the
encoder's ``n_frames``).

Slot semantics are the reference's: an entry with absolute position p lives
at slot ``p % cache_len``; ``pos`` maps slot -> absolute position (-1 =
empty), which the decode attention consumes directly. The port keeps one
module per layer, so its cache is a list with one entry dict per layer, not
the reference's ``{"blocks": stacked, "tail": ...}`` tree.
"""
from __future__ import annotations

import torch

from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import dtype_of


def quantize_kv(x, bits):
    """Symmetric per-(token, kv-head) quantization of k or v (B, S, Hkv, D)
    -> (codes int8, scale (B, S, Hkv) f32). Paper Eq. 1 applied to the
    serving cache."""
    levels = (1 << (bits - 1)) - 1
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(-1) / levels, min=1e-8)
    codes = torch.clamp(torch.round(xf / scale[..., None]), -levels, levels).to(torch.int8)
    return codes, scale


def dequantize_kv(codes, scale, dtype):
    return (codes.to(torch.float32) * scale[..., None]).to(dtype)


def pack_full_kv(k, v, positions, cache_len, window=0, kv_bits=0):
    """Build a decode cache entry from full-sequence k/v (prefill).

    k, v: (B, S, Hkv, D); positions: (B, S). cache_len: allocated length
    (window if window > 0). Entries beyond capacity keep only the most
    recent. kv_bits > 0 stores int8 codes + per-(slot, head) scales.
    """
    lc = window if window else cache_len
    b, s, hkv, dh = k.shape
    scales = {}
    if kv_bits:
        k, scales["k_scale"] = quantize_kv(k, kv_bits)
        v, scales["v_scale"] = quantize_kv(v, kv_bits)
    positions = positions.to(torch.int32)
    if s >= lc:
        # the last lc positions, each at its ring slot
        slots = torch.remainder(positions[0, -lc:], lc).long()
        take = lambda t: t[:, -lc:]
    else:
        slots = slice(0, s)
        take = lambda t: t
    entry = {"k": k.new_zeros((b, lc, hkv, dh)), "v": v.new_zeros((b, lc, hkv, dh)),
             "pos": torch.full((b, lc), -1, dtype=torch.int32, device=k.device)}
    entry["k"][:, slots] = take(k)
    entry["v"][:, slots] = take(v)
    entry["pos"][:, slots] = take(positions)
    for name, sc in scales.items():
        entry[name] = sc.new_zeros((b, lc, hkv))
        entry[name][:, slots] = take(sc)
    return entry


def entry_shape(cfg, btype, batch, attn_len):
    """{name: (shape, dtype)} of one layer's cache."""
    cdt = dtype_of(cfg.compute_dtype)
    if btype == "mamba2":
        d_inner, h, pdim, n, d_conv = ssm_lib.dims(cfg)
        return {"conv_x": ((batch, d_conv - 1, d_inner), cdt),
                "conv_bc": ((batch, d_conv - 1, 2 * n), cdt),
                "h": ((batch, h, pdim, n), torch.float32)}
    if btype == "rec":
        return {"conv": ((batch, 3, cfg.d_model), cdt),
                "h": ((batch, cfg.d_model), torch.float32)}
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    if btype == "xattn":
        return {"ck": ((batch, cfg.n_aux_tokens, hkv, dh), cdt),
                "cv": ((batch, cfg.n_aux_tokens, hkv, dh), cdt)}
    if btype not in ("dense", "lattn", "moe", "enc", "decx"):
        raise ValueError(f"unknown block type {btype}")
    lc = cfg.window if btype == "lattn" else attn_len
    kv_dt = torch.int8 if cfg.kv_quant_bits else cdt
    e = {"k": ((batch, lc, hkv, dh), kv_dt),
         "v": ((batch, lc, hkv, dh), kv_dt),
         "pos": ((batch, lc), torch.int32)}
    if cfg.kv_quant_bits:
        e["k_scale"] = ((batch, lc, hkv), torch.float32)
        e["v_scale"] = ((batch, lc, hkv), torch.float32)
    if btype == "decx":
        nf = cfg.encoder.n_frames
        e["ck"] = ((batch, nf, hkv, dh), cdt)
        e["cv"] = ((batch, nf, hkv, dh), cdt)
    return e


def entry_payload_bits(cfg, btype, batch, ctx_len):
    """Bits to ship one layer's serving-cache state for a ``ctx_len``-token
    context: ``entry_shape``'s leaves with the sequence axis at the filled
    length (min(ctx_len, window) for a ``"lattn"`` layer: its ring never
    holds more), honoring ``kv_quant_bits`` (int8 codes + f32 per-(slot,
    head) scales). Mamba-2 and RG-LRU layers carry O(1) state, a
    cross-attention layer its whole context's K/V. ``core.split.
    llm_decode_split_table`` sums this over the UE-side layers."""
    ctx_len = int(ctx_len)
    if ctx_len < 1:
        raise ValueError("ctx_len must be >= 1")
    if btype == "lattn" and cfg.window:
        cfg = cfg.replace(window=min(ctx_len, cfg.window))
    total = 0
    for shape, dtype in entry_shape(cfg, btype, batch, ctx_len).values():
        n = 1
        for s in shape:
            n *= int(s)
        total += n * dtype.itemsize * 8
    return int(total)


def make_cache(cfg, batch, attn_len, device=None, mesh=None):
    """One zero entry per layer (pos leaves -1), of a global ``batch``;
    under ``mesh`` each leaf is this rank's block of it
    (``sharding.entry_pspec``: the batch over the data axes where they
    divide it, a KV cache's length over "model", or its kv heads where the
    length does not divide)."""
    def leaf(name, shape, dtype):
        if mesh is not None:
            from repro_torch.models.sharding import entry_pspec, shard_shape
            shape = shard_shape(shape, entry_pspec(name, shape, mesh), mesh)
        if name == "pos":
            return torch.full(shape, -1, dtype=dtype, device=device)
        return torch.zeros(shape, dtype=dtype, device=device)
    out = []
    for bt in cfg.block_types():
        shapes = entry_shape(cfg, bt, batch, attn_len)
        m = 1 if mesh is None else mesh.shape["model"]
        if "pos" in shapes and shapes["pos"][0][1] % m and cfg.n_kv_heads % m:
            raise ValueError(f"a cache of {shapes['pos'][0][1]} slots and {cfg.n_kv_heads} kv "
                             f"heads splits neither way over a model axis of {m}: give it a "
                             f"length the axis divides")
        out.append({name: leaf(name, *sd) for name, sd in shapes.items()})
    return out
