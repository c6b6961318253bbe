"""Synthetic data pipelines, the port of ``src/repro/data/synthetic.py``.

* Images: a procedural 101-class stand-in for Caltech-101. Each class is a
  fixed random frequency / phase pattern (``_class_basis``, numpy, the
  reference's bits); samples add noise, a random circular shift and an
  amplitude jitter.
* Tokens: an order-1 Markov chain over a vocabulary (``_markov_table``,
  numpy, the reference's bits): each token has ``n_modes`` successors with
  Gumbel logits, so the next-token distribution is learnable.

The reference draws with ``jax.random``, which torch cannot reproduce; the
draws here come from an explicit ``torch.Generator`` and follow the same
distributions (the tests hold them by distribution).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _class_basis(n_classes: int, size: int) -> np.ndarray:
    """(n_classes, 3, size, size) float32: three sinusoids a class."""
    rng = np.random.RandomState(1234)
    fx = rng.uniform(0.5, 6.0, (n_classes, 3))
    fy = rng.uniform(0.5, 6.0, (n_classes, 3))
    ph = rng.uniform(0, 2 * np.pi, (n_classes, 3))
    xx, yy = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size))
    basis = np.sin(2 * np.pi * (fx[:, :, None, None] * xx + fy[:, :, None, None] * yy)
                   + ph[:, :, None, None])
    return basis.astype(np.float32)


_BASIS_CACHE = {}


def synthetic_image_batch(generator: torch.Generator, batch, size, n_classes=101, noise=0.3):
    """Returns (x (B, 3, S, S) float32, labels (B,) int64) on the
    generator's device: the class pattern times an amplitude in [0.7, 1.3),
    rolled by a shift in [0, S) along the last axis, plus ``noise`` times a
    standard normal."""
    dev = generator.device
    ck = (n_classes, size, str(dev))
    if ck not in _BASIS_CACHE:
        _BASIS_CACHE[ck] = torch.from_numpy(_class_basis(n_classes, size)).to(dev)
    basis = _BASIS_CACHE[ck]
    labels = torch.randint(0, n_classes, (batch,), generator=generator, device=dev)
    amp = torch.rand((batch, 1, 1, 1), generator=generator, device=dev) * 0.6 + 0.7
    x = basis[labels] * amp
    shift = torch.randint(0, size, (batch,), generator=generator, device=dev)
    cols = (torch.arange(size, device=dev) - shift[:, None]) % size     # roll by shift
    x = torch.gather(x, -1, cols[:, None, None, :].expand_as(x))
    x = x + noise * torch.randn(x.shape, generator=generator, device=dev)
    return x, labels


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int = 8192
    seq_len: int = 256
    batch: int = 8
    order: int = 1
    n_modes: int = 64      # sparsity of the transition rows


def _markov_table(vocab, n_modes, seed=7):
    """(nexts (vocab, n_modes) int32, logits (vocab, n_modes) float32)."""
    rng = np.random.RandomState(seed)
    nexts = rng.randint(0, vocab, (vocab, n_modes)).astype(np.int32)
    logits = rng.gumbel(size=(vocab, n_modes)).astype(np.float32)
    return nexts, logits


_TOKEN_CACHE = {}


def token_batch_stream(cfg: TokenPipelineConfig, seed=0, device=None):
    """Generator of {"tokens", "labels"} batches, each (batch, seq_len)
    int64 on ``device`` (the CPU by default): a start token uniform over the
    vocabulary, then ``seq_len`` steps of the chain, each successor drawn
    from the softmax of its row's logits (Gumbel-max); tokens are the start
    and the first seq_len - 1 draws, labels the draws. The chain runs on the
    CPU with a host ``torch.Generator`` seeded by ``seed`` (its seq_len
    steps depend on each other, and each is a small gather), and each batch
    moves to ``device`` once."""
    ck = (cfg.vocab_size, cfg.n_modes)
    if ck not in _TOKEN_CACHE:
        _TOKEN_CACHE[ck] = _markov_table(cfg.vocab_size, cfg.n_modes)
    nexts, logits = _TOKEN_CACHE[ck]
    gen = torch.Generator().manual_seed(seed)
    b, s = cfg.batch, cfg.seq_len
    while True:
        cur = torch.randint(0, cfg.vocab_size, (b,), generator=gen).numpy()
        u = torch.rand((s, b, cfg.n_modes), generator=gen).clamp_(min=1e-20)
        gumbel = (-torch.log(-torch.log(u))).numpy()
        toks = np.empty((b, s), dtype=np.int64)
        nxt = cur
        for step in range(s):   # small gathers: numpy's per-call cost is the least
            nxt = nexts[nxt, np.argmax(logits[nxt] + gumbel[step], axis=-1)]
            toks[:, step] = nxt
        tokens = np.concatenate([cur[:, None], toks[:, :-1]], axis=1)
        yield {"tokens": torch.from_numpy(tokens).to(device),
               "labels": torch.from_numpy(toks).to(device)}
