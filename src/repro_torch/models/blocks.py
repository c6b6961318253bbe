"""Residual blocks of the port (``src/repro/models/blocks.py``): the
``"dense"`` block (attention + MLP), the ``"lattn"`` block (the same with
local attention over a ``cfg.window`` ring), the ``"moe"`` block
(attention + the MoE FFN), the ``"rec"`` block (RG-LRU + MLP, Griffin) and
the ``"mamba2"`` block (SSD mixer), each in the modes ``"train"`` (no
cache), ``"prefill"`` (build the layer's cache entry) and ``"decode"``
(one token: consume and update it). Every block takes ``aux``, a list
into which an MoE block appends its load-balance loss; the others add
nothing.
"""
from __future__ import annotations

from torch import nn

from repro_torch.models.attention import Attention, self_attention
from repro_torch.models.cache import pack_full_kv
from repro_torch.models.layers import MLP, Norm
from repro_torch.models.moe import MoE, apply_moe
from repro_torch.models.rglru import RGLRU, apply_rglru, decode_rglru
from repro_torch.models.ssm import Mamba, apply_mamba, decode_mamba

_LATER = {
    "enc": "the encoder-decoder slice",
    "decx": "the encoder-decoder slice",
    "xattn": "the VLM slice",
}
MODES = ("train", "prefill", "decode")


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


class DenseBlock(nn.Module):
    """``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``; with ``window`` > 0
    (the ``"lattn"`` block) the attention is local: a key at position p
    serves the queries at p .. p + window - 1, and the cache is a ring of
    ``window`` slots."""

    def __init__(self, cfg, *, window=0, device=None):
        super().__init__()
        self.cfg = cfg
        self.window = window
        self.ln1 = Norm(cfg, device=device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = Norm(cfg, device=device)
        self.mlp = MLP(cfg, device=device)

    def ffn(self, h, aux):
        return self.mlp(h)

    def forward(self, x, positions, *, mode="train", cache=None, idx=None, attn_len=0,
                aux=None):
        """Train mode returns x; prefill and decode return (x, cache entry).
        Decode writes the token's position into the entry's ``pos`` at slot
        ``idx % L`` before the attention, and its k/v in place."""
        _check_mode(mode)
        h = self.ln1(x)
        if mode == "decode":
            slot = idx % cache["k"].shape[1]
            pos_buf = cache["pos"]
            pos_buf[:, slot] = positions[:, 0].to(pos_buf.dtype)
            out, kv = self_attention(self.attn, h, self.cfg, positions, window=self.window,
                                     kv_cache=cache, cache_slot=slot, cache_positions=pos_buf,
                                     idx=idx)
            entry = dict(kv, pos=pos_buf)
        else:
            out, (k, v) = self_attention(self.attn, h, self.cfg, positions, window=self.window)
            entry = (None if mode == "train" else
                     pack_full_kv(k, v, positions, attn_len, window=self.window,
                                  kv_bits=self.cfg.kv_quant_bits))
        x = x + out
        x = x + self.ffn(self.ln2(x), aux)
        return x if mode == "train" else (x, entry)


class MoEBlock(DenseBlock):
    """``x + attn(ln1(x))``, then ``x + moe(ln2(x))``; its cache is the
    dense block's. The MoE routes the tokens of the call: in decode the B
    tokens of the step, so its capacity is ``max(1, ceil(B k / E
    capacity_factor))`` and colliding assignments are dropped, as the
    reference's single-device path drops them."""

    def __init__(self, cfg, *, device=None):
        nn.Module.__init__(self)
        self.cfg = cfg
        self.window = 0
        self.ln1 = Norm(cfg, device=device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = Norm(cfg, device=device)
        self.moe = MoE(cfg, device=device)

    def ffn(self, h, aux):
        out, a = apply_moe(self.moe, h, self.cfg)
        if aux is not None:
            aux.append(a)
        return out


class RecBlock(nn.Module):
    """``x + rglru(ln1(x))``, then ``x + mlp(ln2(x))``; the positions are
    not used (the recurrence is causal by construction). Its cache entry is
    the mixer's state {"conv", "h"}."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Norm(cfg, device=device)
        self.mixer = RGLRU(cfg, device=device)
        self.ln2 = Norm(cfg, device=device)
        self.mlp = MLP(cfg, device=device)

    def forward(self, x, positions=None, *, mode="train", cache=None, idx=None, attn_len=0,
                aux=None):
        """Train mode returns x; prefill and decode return (x, state)."""
        _check_mode(mode)
        h = self.ln1(x)
        if mode == "decode":
            out, entry = decode_rglru(self.mixer, h, self.cfg, cache)
        else:
            out, entry = apply_rglru(self.mixer, h, self.cfg)
        x = x + out
        x = x + self.mlp(self.ln2(x))
        return x if mode == "train" else (x, entry)


class Mamba2Block(nn.Module):
    """``x + mixer(ln1(x))``; the positions are not used (the SSD mixer is
    causal by construction). Its cache entry is the mixer's state."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Norm(cfg, device=device)
        self.mixer = Mamba(cfg, device=device)

    def forward(self, x, positions=None, *, mode="train", cache=None, idx=None, attn_len=0,
                aux=None):
        """Train mode returns x; prefill and decode return (x, state)."""
        _check_mode(mode)
        h = self.ln1(x)
        if mode == "decode":
            out, entry = decode_mamba(self.mixer, h, self.cfg, cache)
        else:
            out, entry = apply_mamba(self.mixer, h, self.cfg)
        x = x + out
        return x if mode == "train" else (x, entry)


def make_block(cfg, btype, *, device=None):
    if btype == "dense":
        return DenseBlock(cfg, device=device)
    if btype == "lattn":
        return DenseBlock(cfg, window=cfg.window, device=device)
    if btype == "moe":
        return MoEBlock(cfg, device=device)
    if btype == "rec":
        return RecBlock(cfg, device=device)
    if btype == "mamba2":
        return Mamba2Block(cfg, device=device)
    if btype in _LATER:
        raise NotImplementedError(
            f"block type {btype!r} is not ported yet; it comes with {_LATER[btype]}")
    raise ValueError(f"unknown block type {btype}")
