"""Model assembly of the port: embedding -> blocks -> final norm -> head
(``src/repro/models/model.py``). The reference scans over layer-stacked
parameters; the port keeps one module per layer, so a split forward can run
layers ``lo..hi`` on their own (``Model.run_layers``)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.blocks import make_block
from repro_torch.models.layers import Norm, dense_init, dtype_of, embed_init


def layer_plan(cfg):
    """(pattern, n_groups, tail block types), as the reference."""
    pat = tuple(cfg.block_pattern)
    n_groups = cfg.n_layers // len(pat)
    tail = tuple(pat[i % len(pat)]
                 for i in range(n_groups * len(pat), cfg.n_layers))
    return pat, n_groups, tail


class Model(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              dtype=dt, device=device))
        self.blocks = nn.ModuleList(make_block(cfg, bt, device=device)
                                    for bt in cfg.block_types())
        self.ln_f = Norm(cfg, device=device)
        self.lm_head = (None if cfg.tie_embeddings else nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab_size, dtype=dt, device=device)))

    def embed_tokens(self, tokens):
        """Token embeddings, in the parameters' dtype (no cast)."""
        return self.embed[tokens]

    def run_layers(self, x, lo, hi, positions):
        for blk in self.blocks[lo:hi]:
            x = blk(x, positions)
        return x

    def logits(self, x):
        """The head: the tied embedding or ``lm_head``."""
        return x @ (self.embed.T if self.lm_head is None else self.lm_head)

    def forward(self, tokens, positions=None):
        return apply_model(self, tokens, positions=positions)


def default_positions(b, s, device):
    """Positions 0..s-1 for each of the b sequences."""
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def apply_model(model, tokens, *, positions=None, mode="train"):
    """tokens: (B, S) int. Returns logits (B, S, vocab). Only the
    cache-free ``"train"`` mode is ported; prefill and decode come with the
    KV-cache slice."""
    if mode != "train":
        raise NotImplementedError(f"mode {mode!r} comes with the KV-cache slice")
    cfg = model.cfg
    if positions is None:
        positions = default_positions(*tokens.shape, tokens.device)
    x = model.embed_tokens(tokens).to(dtype_of(cfg.compute_dtype))
    x = model.run_layers(x, 0, cfg.n_layers, positions)
    return model.logits(model.ln_f(x))


@torch.no_grad()
def init_params(cfg, generator, device):
    """A model with the reference's initializers, drawn from ``generator``
    (which must live on ``device``): normal(0, 1/sqrt(fan_in)) matrices
    (the Mamba conv kernels included: fan-in d_conv), normal(0, 0.02)
    embeddings, unit norm, qk-norm and Mamba ``D`` / ``norm_scale``, zero
    biases, ``A_log`` and ``dt_bias``."""
    model = Model(cfg, device=device)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name == "embed":
            p.copy_(embed_init(generator, p.shape, p.dtype, device))
        elif p.dim() == 2:
            p.copy_(dense_init(generator, p.shape, p.dtype, device))
        elif leaf in ("scale", "q_scale", "k_scale", "D", "norm_scale"):
            p.fill_(1.0)
        else:
            p.zero_()
    return model
