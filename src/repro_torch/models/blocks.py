"""Residual blocks of the port (``src/repro/models/blocks.py``): the
``"dense"`` block (attention + MLP), the ``"lattn"`` block (the same with
local attention over a ``cfg.window`` ring), the ``"enc"`` block (the same
with bidirectional attention: the encoder's, train mode only), the
``"moe"`` block (attention + the MoE FFN), the ``"rec"`` block (RG-LRU +
MLP, Griffin), the ``"mamba2"`` block (SSD mixer), the ``"xattn"`` block
(gated cross-attention + MLP, the VLM's image layers) and the ``"decx"``
block (self-attention, ungated cross-attention over the encoder's output,
MLP), each in the modes ``"train"`` (no cache), ``"prefill"`` (build the
layer's cache entry) and ``"decode"`` (one token: consume and update it).
Every block takes ``aux``, a list into which an MoE block appends its
load-balance loss (the others add nothing), and ``context``, the (B, Sc,
d) sequence the cross-attention blocks attend to in train and prefill
mode (the others ignore it); at decode those read the context's K/V from
their cache entry.

Every block takes ``seq_parallel``, set in train and prefill where the
residual stream is sequence-parallel (``meshctx.seq_parallel``): x is
then this rank's block of S / model positions, and each residual branch
runs its norm on the block, all-gathers the normed output whole along the
sequence (``tp.seq_gather``), runs its sublayer unchanged on the whole
sequence with the rank's heads or columns, and gets back the rank's block
of the sublayer's output (its row-parallel product reduce-scattered along
the sequence, ``scatter_seq``) for the add. Positions, the context and
the cache entry stay those of the whole sequence.
"""
from __future__ import annotations

from torch import nn

from repro_torch.models import tp
from repro_torch.models.attention import (Attention, cross_attention, pack_context,
                                          self_attention)
from repro_torch.models.layers import MLP, Norm
from repro_torch.models.moe import MoE, apply_moe
from repro_torch.models.rglru import RGLRU, apply_rglru, decode_rglru
from repro_torch.models.ssm import Mamba, apply_mamba, decode_mamba

MODES = ("train", "prefill", "decode")


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def _whole(h, seq_parallel):
    """``h``, gathered whole along the sequence where it is this rank's
    block of it (``seq_parallel``)."""
    return tp.seq_gather(h) if seq_parallel else h


class DenseBlock(nn.Module):
    """``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``; with ``window`` > 0
    (the ``"lattn"`` block) the attention is local: a key at position p
    serves the queries at p .. p + window - 1, and the cache is a ring of
    ``window`` slots; with ``causal`` False (the ``"enc"`` block) every
    query sees every key."""

    def __init__(self, cfg, *, window=0, causal=True, device=None):
        super().__init__()
        self.cfg = cfg
        self.window = window
        self.causal = causal
        self.ln1 = Norm(cfg, device=device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = Norm(cfg, device=device)
        self.mlp = MLP(cfg, device=device)

    def ffn(self, x, aux, seq_parallel=False):
        """The last residual branch, ``mlp(ln2(x))``."""
        return self.mlp(_whole(self.ln2(x), seq_parallel), scatter_seq=seq_parallel)

    def forward(self, x, positions, *, mode="train", cache=None, idx=None, attn_len=0,
                aux=None, context=None, seq_parallel=False):
        """Train mode returns x; prefill and decode return (x, cache entry).
        Decode writes the token's position into the entry's ``pos`` at slot
        ``idx % L`` before the attention, and its k/v in place."""
        _check_mode(mode)
        x, entry = self.attend(x, positions, mode, cache, idx, attn_len, seq_parallel)
        x = x + self.ffn(x, aux, seq_parallel)
        return x if mode == "train" else (x, entry)

    def attend(self, x, positions, mode, cache, idx, attn_len, seq_parallel=False):
        """The first residual half: (x + attn(ln1(x)), cache entry). Decode
        writes the token's position, k and v into the entry at slot ``idx %
        L``, in place; under a mesh it is the rank's program."""
        out, entry = self_attention(self.attn, _whole(self.ln1(x), seq_parallel), self.cfg,
                                    positions, causal=self.causal, window=self.window,
                                    cache=cache if mode == "decode" else None, idx=idx,
                                    attn_len=attn_len, prefill=mode == "prefill" and self.causal,
                                    scatter_seq=seq_parallel)
        return x + out, entry


def attend_context(attn, h, cfg, mode, cache, context, scatter_seq=False):
    """Cross-attention of ``h`` over ``context`` (train and prefill) or over
    the context's K/V in the layer's cache entry (decode). Returns (out,
    {"ck", "cv"} for the layer's entry, under a mesh the rank's blocks
    (``pack_context``); None in train mode); with ``scatter_seq`` out is
    the rank's block of the sequence."""
    if mode == "decode":
        out, _ = cross_attention(attn, h, cfg, kv=(cache["ck"], cache["cv"]))
        return out, {"ck": cache["ck"], "cv": cache["cv"]}
    out, (ck, cv) = cross_attention(attn, h, cfg, context=context, scatter_seq=scatter_seq)
    return out, (None if mode == "train" else pack_context(ck, cv, cfg))


class DecXBlock(DenseBlock):
    """The encoder-decoder's decoder layer: ``x + attn(ln1(x))``, then ``x +
    xattn(lnx(x))`` over the encoder's output (ungated), then ``x +
    mlp(ln2(x))``. Its cache entry is the dense entry plus the context's
    ``ck``, ``cv`` (B, n_frames, Hkv, D), made at prefill and carried into
    every decode entry."""

    def __init__(self, cfg, *, device=None):
        super().__init__(cfg, device=device)
        self.lnx = Norm(cfg, device=device)
        self.xattn = Attention(cfg, device=device)

    def forward(self, x, positions, *, mode="train", cache=None, idx=None, attn_len=0,
                aux=None, context=None, seq_parallel=False):
        _check_mode(mode)
        x, entry = self.attend(x, positions, mode, cache, idx, attn_len, seq_parallel)
        out, ctx_kv = attend_context(self.xattn, _whole(self.lnx(x), seq_parallel), self.cfg,
                                     mode, cache, context, seq_parallel)
        x = x + out
        x = x + self.ffn(x, aux, seq_parallel)
        return x if mode == "train" else (x, dict(entry, **ctx_kv))


class XAttnBlock(nn.Module):
    """The VLM's image layer: ``x + tanh(gate) xattn(ln1(x))`` over the
    context, then ``x + mlp(ln2(x))``; the positions are not used. Its cache
    entry is the context's ``ck``, ``cv`` (B, n_aux_tokens, Hkv, D), made at
    prefill and read, unchanged, at decode."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Norm(cfg, device=device)
        self.xattn = Attention(cfg, cross=True, device=device)
        self.ln2 = Norm(cfg, device=device)
        self.mlp = MLP(cfg, device=device)

    def forward(self, x, positions=None, *, mode="train", cache=None, idx=None, attn_len=0,
                aux=None, context=None, seq_parallel=False):
        _check_mode(mode)
        out, entry = attend_context(self.xattn, _whole(self.ln1(x), seq_parallel), self.cfg,
                                    mode, cache, context, seq_parallel)
        x = x + out
        x = x + self.mlp(_whole(self.ln2(x), seq_parallel), scatter_seq=seq_parallel)
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
        self.causal = True
        self.ln1 = Norm(cfg, device=device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = Norm(cfg, device=device)
        self.moe = MoE(cfg, device=device)

    def ffn(self, x, aux, seq_parallel=False):
        """The last residual branch, ``moe(ln2(x))``; its aux loss goes to
        ``aux``. Under a sequence-parallel residual the MoE routes the
        gathered, whole sequence."""
        out, a = apply_moe(self.moe, _whole(self.ln2(x), seq_parallel), self.cfg,
                           scatter_seq=seq_parallel)
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
                aux=None, context=None, seq_parallel=False):
        """Train mode returns x; prefill and decode return (x, state)."""
        _check_mode(mode)
        h = self.ln1(x)
        if mode == "decode":
            out, entry = decode_rglru(self.mixer, h, self.cfg, cache)
        else:
            h = _whole(h, seq_parallel)     # the block's norm is not kept past the gather
            out, entry = apply_rglru(self.mixer, h, self.cfg, scatter_seq=seq_parallel)
        x = x + out
        x = x + self.mlp(_whole(self.ln2(x), seq_parallel), scatter_seq=seq_parallel)
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
                aux=None, context=None, seq_parallel=False):
        """Train mode returns x; prefill and decode return (x, state)."""
        _check_mode(mode)
        h = self.ln1(x)
        if mode == "decode":
            out, entry = decode_mamba(self.mixer, h, self.cfg, cache)
        else:
            h = _whole(h, seq_parallel)     # the block's norm is not kept past the gather
            out, entry = apply_mamba(self.mixer, h, self.cfg, scatter_seq=seq_parallel)
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
    if btype == "enc":
        return DenseBlock(cfg, causal=False, device=device)
    if btype == "xattn":
        return XAttnBlock(cfg, device=device)
    if btype == "decx":
        return DecXBlock(cfg, device=device)
    raise ValueError(f"unknown block type {btype}")
