"""Policy networks of the scheduler, the port of ``src/repro/rl/nets.py``.

Weights keep the reference's (d_in, d_out) layout: a layer is
``x @ w + b`` with tanh between layers and the last linear. Every network
is generic over the env's :class:`HybridActionSpace`, and takes any leading
batch axes.

* The actor (paper Fig. 3) is a trunk (D -> 256 -> 128, tanh on its
  output) and one (128, 64, n) branch per head. The paper's per-UE actors
  are N of them held as one :class:`Actor` of :class:`StackedLinear`
  layers (weights (N, d_in, d_out)), every actor reading the same flat
  global observation: the counterpart of the reference's ``vmap`` over
  actors. The weight-shared actor is one plain :class:`Actor` applied to
  every ``observe_per_ue`` row. The critic is one (D, 256, 128, 64, 1)
  MLP.

* The entity actor encodes UE rows (15 -> 192 -> 128) and server rows
  (4 -> 32), scores every (UE, server) pair with one shared MLP
  (128 + 32 + 3 -> 48 -> 1) into (N, E) route logits, attention-pools the
  server embeddings with their softmax, and feeds [ue ‖ ctx] (160) to one
  (160, 64, n) branch per other head. Its kernel path (an obs with a
  "raw" block) routes the scorer through ``kernels.ops.pair_scorer``, one
  launch for every env or minibatch sample, with a hand-written backward.
* The flat trunk is one tanh MLP (19 -> 64 -> 64 -> 13) over
  ``observe_per_ue`` rows emitting every head in one pass; its int8 form
  ({"qlayers", "bits"}) runs through ``kernels.ops.flat_trunk``.

Initialization is orthogonal as in the reference (the same distribution,
not the same numbers), from an explicit ``torch.Generator`` on the CPU.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from repro_torch.kernels import ops
from repro_torch.rl.actionspace import LOG_STD_MAX, LOG_STD_MIN, HybridActionSpace, _mask_logits

SRV_EMBED = 32               # server embedding width (route scorer input)


class Linear(nn.Module):
    """``x @ w + b`` with w (d_in, d_out), as the reference's layers."""

    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x):
        return x @ self.w + self.b

    def params(self):
        return {"w": self.w, "b": self.b}


class StackedLinear(nn.Module):
    """N independent layers, ``x[..., i, :] @ w[i] + b[i]`` with w (N, d_in,
    d_out) and b (N, d_out): a :class:`Linear` vmapped over an actor axis."""

    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x):
        return torch.einsum("...nd,nde->...ne", x, self.w) + self.b


class MLP(nn.Module):
    """Linear layers with tanh between them, the last linear."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.tanh(x)
        return x


def _orthogonal(gen, n):
    """A Haar-random (n, n) orthogonal matrix (QR of a Gaussian, signs
    fixed by R's diagonal), as ``jax.random.orthogonal``."""
    q, r = torch.linalg.qr(torch.randn((n, n), generator=gen, dtype=torch.float64))
    return q * torch.sign(torch.diagonal(r))[None, :]


def _linear_init(gen, nin, nout, scale=math.sqrt(2.0), device=None):
    w = _orthogonal(gen, max(nin, nout))[:nin, :nout] * scale
    # row-major like the reference's (QR returns a column-major Q)
    return Linear(w.to(torch.float32).contiguous().to(device),
                  torch.zeros((nout,), device=device))


def _mlp_init(gen, sizes, out_scale=0.01, device=None):
    layers = []
    for i in range(len(sizes) - 1):
        scale = out_scale if i == len(sizes) - 2 else math.sqrt(2.0)
        layers.append(_linear_init(gen, sizes[i], sizes[i + 1], scale, device))
    return MLP(layers)


def _stack_mlps(mlps):
    """N MLPs of equal widths -> one MLP of :class:`StackedLinear` layers."""
    return MLP([StackedLinear(torch.stack([m.layers[i].w.data for m in mlps]),
                              torch.stack([m.layers[i].b.data for m in mlps]))
                for i in range(len(mlps[0].layers))])


class Actor(nn.Module):
    """Trunk (D, 256, 128) and one (128, 64, n) branch per head. With
    ``n_actors`` set its layers are :class:`StackedLinear`: the paper's N
    per-UE actors, each reading the same global observation."""

    def __init__(self, trunk: MLP, heads: nn.ModuleDict, n_actors=None):
        super().__init__()
        self.trunk, self.heads, self.n_actors = trunk, heads, n_actors


def init_actor(gen, obs_dim, space: HybridActionSpace, device=None):
    """One actor, trunk first and then the heads in declaration order."""
    return Actor(_mlp_init(gen, (obs_dim, 256, 128), out_scale=math.sqrt(2.0), device=device),
                 space.init_heads(gen, 128, _mlp_init, device=device))


def init_actor_stack(gen, n_actors, obs_dim, space: HybridActionSpace, device=None):
    """The paper's per-UE actors: ``n_actors`` independent inits, one after
    another from ``gen``, held as one stacked :class:`Actor`."""
    actors = [init_actor(gen, obs_dim, space, device) for _ in range(n_actors)]
    heads = nn.ModuleDict({name: _stack_mlps([a.heads[name] for a in actors])
                           for name in actors[0].heads})
    return Actor(_stack_mlps([a.trunk for a in actors]), heads, n_actors)


def actor_forward(p: Actor, space: HybridActionSpace, obs, masks=None):
    """obs (..., D) for a per-UE stack (the flat global observation, read by
    every actor) or (..., F) rows for a single actor -> the per-head
    distribution dict; a stack's has an actor axis (..., N, ...)."""
    if p.n_actors is not None:
        obs = obs.unsqueeze(-2).expand(*obs.shape[:-1], p.n_actors, obs.shape[-1])
    h = torch.tanh(p.trunk(obs))
    return space.forward(p.heads, h, masks)


def shared_actor_forward(p: Actor, space: HybridActionSpace, feats, masks):
    """ONE actor over every fleet row: feats (..., N, F) ``observe_per_ue``
    rows, masks a complete per-actor dict with (N, n) leaves. The result
    has the same actor axis as the per-UE stack's."""
    return actor_forward(p, space, feats, masks)


def init_critic(gen, obs_dim, device=None):
    """The global critic, (obs_dim, 256, 128, 64, 1)."""
    return _mlp_init(gen, (obs_dim, 256, 128, 64, 1), out_scale=1.0, device=device)


def critic_forward(p: MLP, obs):
    return p(obs)[..., 0]


class EntityActor(nn.Module):
    def __init__(self, ue_enc: MLP, srv_enc: Linear, scorer: MLP, heads: nn.ModuleDict):
        super().__init__()
        self.ue_enc, self.srv_enc, self.scorer, self.heads = ue_enc, srv_enc, scorer, heads


def init_entity_actor(gen, dims, space: HybridActionSpace, device=None):
    """dims: the env's ``entity_dims``. The route head gets no branch: its
    logits come from the shared per-server scorer, so the parameters do
    not depend on the pool size E."""
    return EntityActor(
        _mlp_init(gen, (dims["ue"], 192, 128), out_scale=math.sqrt(2.0), device=device),
        _linear_init(gen, dims["server"], SRV_EMBED, device=device),
        _mlp_init(gen, (128 + SRV_EMBED + dims["edge"], 48, 1), out_scale=0.01,
                  device=device),
        space.init_heads(gen, 128 + SRV_EMBED, _mlp_init, skip=("route",), device=device))


def entity_trunk(p: EntityActor, obs):
    """(ue_embed (..., N, 128), srv_embed (..., E, S), route_logits (..., N,
    E), ctx (..., N, S)). An obs with a "raw" block
    (``env.observe_entities_raw``) runs the scorer through the fused
    ``ops.pair_scorer``, one launch for all leading axes (envs, or
    minibatch samples), differentiable through its backward kernel; the
    default entity obs builds the (..., N, E, 128 + S + 3) pair concat."""
    ue = torch.tanh(p.ue_enc(obs["ue"]))
    if "raw" in obs:
        route_logits, srv = ops.pair_scorer(ue, obs["raw"], p.srv_enc.params(),
                                            [layer.params() for layer in p.scorer.layers])
    else:
        srv = torch.tanh(obs["server"] @ p.srv_enc.w + p.srv_enc.b)
        *lead, n, e, _ = obs["edge"].shape
        pair = torch.cat([ue[..., :, None, :].expand(*lead, n, e, ue.shape[-1]),
                          srv[..., None, :, :].expand(*lead, n, e, srv.shape[-1]),
                          obs["edge"]], dim=-1)
        route_logits = p.scorer(pair)[..., 0]
    ctx = torch.softmax(route_logits, dim=-1) @ srv
    return ue, srv, route_logits, ctx


def entity_actor_forward(p: EntityActor, space: HybridActionSpace, obs, masks):
    """Per-head distribution with a leading actor axis; masks: a complete
    per-actor dict with (N, n) leaves (``space.broadcast_masks``)."""
    ue, _, route_logits, ctx = entity_trunk(p, obs)
    h = torch.cat([ue, ctx], dim=-1)
    return space.forward(p.heads, h, masks, provided={"route": route_logits})


def init_entity_critic(gen, device=None):
    """The entity value head over the mean-pooled trunk embeddings."""
    return _mlp_init(gen, (128 + SRV_EMBED, 64, 1), out_scale=1.0, device=device)


def entity_value_forward(actor_p: EntityActor, head_p: MLP, obs):
    ue, srv, _, _ = entity_trunk(actor_p, obs)
    h = torch.cat([ue.mean(dim=-2), srv.mean(dim=-2)], dim=-1)
    return head_p(h)[..., 0]


def entity_policy_value(actor_p: EntityActor, head_p: MLP, space: HybridActionSpace, obs,
                        masks):
    """(dist, value) from ONE trunk pass, the training path's form of
    ``entity_actor_forward`` and ``entity_value_forward``."""
    ue, srv, route_logits, ctx = entity_trunk(actor_p, obs)
    dist = space.forward(actor_p.heads, torch.cat([ue, ctx], dim=-1), masks,
                         provided={"route": route_logits})
    h = torch.cat([ue.mean(dim=-2), srv.mean(dim=-2)], dim=-1)
    return dist, head_p(h)[..., 0]


# ------------------------------------------------ distilled flat trunk
def trunk_width(space: HybridActionSpace) -> int:
    """One logit per discrete choice plus (mu, log_std) per continuous head."""
    return sum(h.n for h in space.discrete) + 2 * len(space.continuous)


def init_flat_trunk(gen, obs_dim, space: HybridActionSpace, hidden=(64, 64), device=None):
    """The distillation student: a tanh MLP (obs_dim, *hidden, trunk_width)."""
    return _mlp_init(gen, (obs_dim, *hidden, trunk_width(space)), device=device)


def trunk_head_dist(space: HybridActionSpace, out, masks=None):
    """Split the trunk's (N, W) columns into the distribution dict: masked
    logits per discrete head, clipped {"mu", "log_std"} per continuous."""
    dist = {}
    i = 0
    for h in space.discrete:
        logits = out[..., i:i + h.n]
        i += h.n
        dist[h.name] = _mask_logits(logits, None if masks is None else masks.get(h.name))
    for h in space.continuous:
        dist[h.name] = {"mu": out[..., i],
                        "log_std": torch.clamp(out[..., i + 1], LOG_STD_MIN, LOG_STD_MAX)}
        i += 2
    return dist


def flat_trunk_forward(p, space: HybridActionSpace, feats, masks=None):
    """feats: (N, F) ``observe_per_ue`` rows. ``p`` is the f32 trunk (an
    :class:`MLP`) or its weight-quantized form ({"qlayers", "bits"}, from
    ``rl.distill.quantize_flat_trunk``), which runs through the fused
    ``ops.flat_trunk``."""
    if isinstance(p, dict) and "qlayers" in p:
        out = ops.flat_trunk(feats, p["qlayers"], bits=int(p["bits"]))
    else:
        out = p(feats)
    return trunk_head_dist(space, out, masks)


def _leaves(tree):
    if isinstance(tree, nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_count(tree) -> int:
    """Total parameter count of a network, a dict of networks, or a
    quantized trunk (counted leaf by leaf as the reference's pytree)."""
    return sum(int(t.numel()) if isinstance(t, torch.Tensor) else int(np.size(t))
               for t in _leaves(tree))


def param_bytes(tree) -> int:
    """Serving-weight bytes from the leaves' dtypes: 1 per 8-bit code, 4 per
    float32 weight, bias and calibration scalar."""
    return sum(int(t.numel()) * t.element_size() if isinstance(t, torch.Tensor)
               else int(np.size(t)) * np.asarray(t).dtype.itemsize
               for t in _leaves(tree))
