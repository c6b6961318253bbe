"""Hybrid action spaces of the MEC scheduler, the port of
``src/repro/rl/actionspace.py``.

A :class:`HybridActionSpace` is an ordered set of named
:class:`DiscreteHead`\\ s (each optionally carrying a per-actor feasibility
mask) plus bounded :class:`ContinuousHead`\\ s. Actions travel as a dict
``{head.name: tensor}``, the structure the env's ``step`` takes.

The reference writes every function for ONE actor and vmaps it over the
fleet; here the actor axis is written out: logits are ``(..., n)``, masks
``{name: (..., n) bool}`` (broadcast against the logits, so a dynamic
fleet's (E, N, n) masks take the env axis), and every function works on
the last axis.
Random draws take an explicit ``torch.Generator``. Where the envs are
sharded over ranks, a rank holds block ``Rows.index`` of ``Rows.count``
blocks of the env axis: it draws the numbers of every block from the one
generator and keeps its own (``draw_rows``), so the sharded run draws, env
for env, what one process would, and every rank's generator stays in step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn as nn

LOG_STD_MIN, LOG_STD_MAX = -3.0, 1.0
_NEG_INF = -1e9


class DiscreteHead(NamedTuple):
    """A categorical decision with ``n`` choices."""
    name: str
    n: int


class ContinuousHead(NamedTuple):
    """A bounded scalar decision: the policy emits (mu, log_std) over a
    pre-squash u; ``squash`` maps u -> sigmoid(u) * high, ``clamp`` clips
    physical values to [low, high]."""
    name: str
    low: float
    high: float

    def squash(self, u):
        return torch.sigmoid(u) * self.high

    def clamp(self, x):
        return torch.clamp(x, self.low, self.high)


class Rows(NamedTuple):
    """Block ``index`` of ``count`` equal blocks of a leading env axis."""
    index: int
    count: int

    def widen(self, shape):
        """``shape`` with its leading axis grown to all the blocks."""
        return (shape[0] * self.count,) + tuple(shape[1:])

    def keep(self, t):
        """This block of ``t``'s leading axis (of each of a tuple's)."""
        if isinstance(t, tuple):
            return tuple(self.keep(x) for x in t)
        n = t.shape[0] // self.count
        return t[self.index * n:(self.index + 1) * n]


def draw_rows(rows, draw, shape):
    """``draw(shape)``; with ``rows`` (a ``Rows`` or None) this block of
    ``draw`` over every block's rows."""
    return draw(shape) if rows is None else rows.keep(draw(rows.widen(shape)))


def _mask_logits(logits, mask):
    return logits if mask is None else logits.masked_fill(~mask, _NEG_INF)


def _take(log_p, idx):
    """log_p[..., idx] for index tensors of log_p's leading shape."""
    return torch.gather(log_p, -1, idx.long().unsqueeze(-1)).squeeze(-1)


@dataclasses.dataclass(frozen=True)
class HybridActionSpace:
    """Ordered discrete + continuous heads, with optional fleet-level
    feasibility masks ``{name: (N, n) bool}`` for discrete heads. Heads are
    sampled in declaration order, discrete first."""
    discrete: Tuple[DiscreteHead, ...]
    continuous: Tuple[ContinuousHead, ...]
    masks: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def heads(self):
        return self.discrete + self.continuous

    @property
    def names(self):
        return tuple(h.name for h in self.heads)

    def head(self, name):
        for h in self.heads:
            if h.name == name:
                return h
        raise KeyError(f"no head named {name!r}; have {self.names}")

    def __post_init__(self):
        for h in self.discrete:
            if not isinstance(h, DiscreteHead):
                raise TypeError(f"discrete entries must be DiscreteHead, got {h!r}")
        for h in self.continuous:
            if not isinstance(h, ContinuousHead):
                raise TypeError(f"continuous entries must be ContinuousHead, got {h!r}")
        names = [h.name for h in self.heads]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate head names: {names}")
        for name in self.masks:
            if not isinstance(self.head(name), DiscreteHead):
                raise ValueError(f"mask on non-discrete head {name!r}")

    def actor_mask(self, masks, name):
        return None if masks is None else masks.get(name)

    def broadcast_masks(self, masks, n_actors, device=None):
        """Complete mask dict {head: (n_actors, n) bool} for EVERY discrete
        head: heads without an entry get all-True rows. A given mask keeps
        its leading axes (a dynamic fleet's per-env masks, (E, N, n))."""
        out = {}
        for h in self.discrete:
            m = None if masks is None else masks.get(h.name)
            if m is None:
                out[h.name] = torch.ones((n_actors, h.n), dtype=torch.bool, device=device)
            else:
                m = torch.as_tensor(m)
                out[h.name] = m.broadcast_to((*m.shape[:-2], n_actors, h.n))
        return out

    # ------------------------------------------------------------ network
    def init_heads(self, gen, feat_dim, mlp_init, skip=(), device=None):
        """One output branch per head not in ``skip``: (feat_dim, 64, n)
        logits for a discrete head, (feat_dim, 64, 2) (mu, raw_log_std) for
        a continuous one. ``mlp_init(gen, sizes, device)`` builds a branch."""
        out = nn.ModuleDict()
        for h in self.heads:
            if h.name in skip:
                continue
            width = h.n if isinstance(h, DiscreteHead) else 2
            out[h.name] = mlp_init(gen, (feat_dim, 64, width), device=device)
        return out

    def forward(self, head_params, h, masks=None, provided=None):
        """Trunk features (..., F) -> distribution dict: masked logits per
        discrete head, {"mu", "log_std"} per continuous head. ``provided``
        holds logits a network computed itself for skipped heads."""
        dist = {}
        for hd in self.discrete:
            logits = provided[hd.name] if provided and hd.name in provided \
                else head_params[hd.name](h)
            dist[hd.name] = _mask_logits(logits, self.actor_mask(masks, hd.name))
        for hd in self.continuous:
            out = head_params[hd.name](h)
            dist[hd.name] = {"mu": out[..., 0],
                             "log_std": torch.clamp(out[..., 1], LOG_STD_MIN, LOG_STD_MAX)}
        return dist

    # ------------------------------------------------------- distribution
    def sample(self, gen, dist, masks=None, rows=None):
        """One action per head and actor, drawn from ``gen`` in head order
        (Gumbel-max for discrete heads, with the masks re-applied so
        infeasible choices are never drawn). With ``rows`` (a ``Rows``) the
        leading axis is that block of the envs: every block's numbers are
        drawn and this block's kept."""
        actions = {}
        for h in self.heads:
            if isinstance(h, DiscreteHead):
                logits = _mask_logits(dist[h.name], self.actor_mask(masks, h.name))
                u = draw_rows(rows, lambda shape: torch.rand(
                    shape, generator=gen, device=logits.device), logits.shape)
                u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
                actions[h.name] = torch.argmax(logits - torch.log(-torch.log(u)), -1)
            else:
                d = dist[h.name]
                noise = draw_rows(rows, lambda shape: torch.randn(
                    shape, generator=gen, device=d["mu"].device), d["mu"].shape)
                actions[h.name] = d["mu"] + torch.exp(d["log_std"]) * noise
        return actions

    def mode(self, dist, masks=None):
        """Deterministic action: masked argmax (masked choices at -inf) / mu."""
        actions = {}
        for h in self.discrete:
            m = self.actor_mask(masks, h.name)
            logits = dist[h.name] if m is None else dist[h.name].masked_fill(~m, -math.inf)
            actions[h.name] = torch.argmax(logits, -1)
        for h in self.continuous:
            actions[h.name] = dist[h.name]["mu"]
        return actions

    def log_prob(self, dist, actions, active=None):
        """Joint log-prob, summed over heads; inactive actors give 0."""
        out = 0.0
        for h in self.discrete:
            out = out + _take(torch.log_softmax(dist[h.name], -1), actions[h.name])
        for h in self.continuous:
            d = dist[h.name]
            u, mu, ls = actions[h.name], d["mu"], d["log_std"]
            out = out - 0.5 * ((u - mu) ** 2 / torch.exp(2 * ls) + 2 * ls
                               + math.log(2 * math.pi))
        if active is not None:
            out = out * active
        return out

    def entropy(self, dist, active=None):
        """Joint entropy, summed over heads; inactive actors give 0."""
        out = 0.0
        for h in self.discrete:
            p = torch.softmax(dist[h.name], -1)
            out = out - torch.sum(p * torch.log(p + 1e-12), dim=-1)
        for h in self.continuous:
            out = out + 0.5 * math.log(2 * math.pi * math.e) + dist[h.name]["log_std"]
        if active is not None:
            out = out * active
        return out

    # ----------------------------------------------------------- physical
    def execute(self, actions):
        """Squash continuous heads through their bounds; discrete pass."""
        out = dict(actions)
        for h in self.continuous:
            out[h.name] = h.squash(actions[h.name])
        return out

    def clip(self, actions):
        """Clamp physical continuous values into [low, high]."""
        out = dict(actions)
        for h in self.continuous:
            out[h.name] = h.clamp(actions[h.name])
        return out
