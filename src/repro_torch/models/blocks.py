"""Residual blocks of the port (``src/repro/models/blocks.py``): the
``"dense"`` block (attention + MLP) and the ``"mamba2"`` block (SSD
mixer)."""
from __future__ import annotations

from torch import nn

from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Norm
from repro_torch.models.ssm import Mamba

_LATER = {
    "moe": "the MoE slice",
    "rec": "the hybrid (RG-LRU) slice",
    "lattn": "the hybrid (RG-LRU) slice",
    "enc": "the encoder-decoder slice",
    "decx": "the encoder-decoder slice",
    "xattn": "the VLM slice",
}


class DenseBlock(nn.Module):
    """``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.ln1 = Norm(cfg, device=device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = Norm(cfg, device=device)
        self.mlp = MLP(cfg, device=device)

    def forward(self, x, positions):
        x = x + self.attn(self.ln1(x), positions)
        return x + self.mlp(self.ln2(x))


class Mamba2Block(nn.Module):
    """``x + mixer(ln1(x))``; the positions are not used (the SSD mixer is
    causal by construction)."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.ln1 = Norm(cfg, device=device)
        self.mixer = Mamba(cfg, device=device)

    def forward(self, x, positions=None):
        out, _ = self.mixer(self.ln1(x))
        return x + out


def make_block(cfg, btype, *, device=None):
    if btype == "dense":
        return DenseBlock(cfg, device=device)
    if btype == "mamba2":
        return Mamba2Block(cfg, device=device)
    if btype in _LATER:
        raise NotImplementedError(
            f"block type {btype!r} is not ported yet; it comes with {_LATER[btype]}")
    raise ValueError(f"unknown block type {btype}")
