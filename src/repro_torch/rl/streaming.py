"""Streaming fine-tune: distill the occupancy-aware dispatch oracle into the
entity policy; the port of ``src/repro/rl/streaming.py``.

MAHPPO trains the entity policy on the frame MDP's mean-overhead reward;
deployment serves a stream judged on deadline misses and p99 tails
(``stream.qos``). Score-function RL over stream episodes has congestion-
confounded credit, and the frame observation cannot represent live
channel or server occupancy, so the fine-tune is DAgger-style
distillation: roll out the sampled entity policy as the live dispatcher
(with the ``least_loaded_channel`` override every baseline takes), label
every visited state with the action of
:class:`~repro_torch.stream.adapter.StreamOracleDispatcher`, and fit the
actor to the labels through ``entity_actor_forward`` and the action
space's ``log_prob`` (weighted to the deciding UE; continuous labels
pulled back through the sigmoid squash). Datasets aggregate across
iterations. Where the oracle's occupancy-dependent choices hit states the
observation aliases, the policy learns the label marginals, which the
sampling deployment mode turns into load spreading.

Every iteration is scored by ``stream_reward`` over its rollout episodes
and the best-scoring actor (the zero-shot weights included) is returned;
only the actor adapts, the critic rides along untouched.

Each episode's decisions are stacked without padding (the reference pads
to a power of two only to bound XLA retraces, with zero-weight rows that
change no gradient), and each epoch runs ONE ``entity_actor_forward`` over
all aggregated decisions: its loss is the sum of the episodes' weighted
log-probs, so its gradient is the sum of the per-episode gradients.
"""
from __future__ import annotations

import copy
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.env.mecenv import EnvState, MECEnv
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.rl import nets
from repro_torch.stream.adapter import (EntityDispatcher, StreamOracleDispatcher,
                                        stream_env_state)
from repro_torch.stream.events import StreamParams, StreamSim
from repro_torch.stream.qos import StreamRewardConfig, stream_reward


@dataclasses.dataclass(frozen=True)
class StreamTuneConfig:
    """``epochs`` AdamW steps an iteration over the aggregated (all
    iterations so far) labeled dataset."""
    iterations: int = 6
    episodes_per_iter: int = 2
    epochs: int = 10
    lr: float = 3e-3
    reward: StreamRewardConfig = StreamRewardConfig()


def _episode_logp(env: MECEnv, params, states, raws, w):
    """Differentiable weighted sum over T stacked decisions of the deciding
    UE's joint log-prob of ``raws`` (the oracle's labels, {head: (T, N)}).
    ``w``: (T, N), the deciding UE's one-hot (scaled)."""
    space = env.action_space
    masks = space.broadcast_masks(env.action_masks(states), env.params.n_ue, device=env.device)
    dist = nets.entity_actor_forward(params, space, env.observe_entities(states), masks)
    return (space.log_prob(dist, raws) * w).sum()


def label_raw(space, n_ue, lab):
    """A physical oracle action (of the deciding UE) -> a full (N,) raw
    action dict for ``log_prob``, as CPU tensors: discrete indices pass
    through, continuous values pull back through the sigmoid squash,
    u = logit(clip(p / high, 1e-4, 1 - 1e-4))."""
    out = {}
    for h in space.discrete:
        out[h.name] = torch.full((n_ue,), int(lab.get(h.name, 0)), dtype=torch.int32)
    for h in space.continuous:
        frac = float(np.clip(lab[h.name] / h.high, 1e-4, 1 - 1e-4))
        out[h.name] = torch.full((n_ue,), float(np.log(frac / (1.0 - frac))),
                                 dtype=torch.float32)
    return out


def _stack_decisions(env: MECEnv, decisions):
    """(states, labels, weights) stacked over (EnvState, label dict, ue)
    records on the env's device: EnvState leaves (T, N), labels {head: (T,
    N)}, weights (T, N) the deciding UE's one-hot."""
    snaps = [d[0] for d in decisions]
    stack = lambda f: torch.stack([getattr(s, f) for s in snaps])
    states = EnvState(k=stack("k"), l=stack("l"), n=stack("n"), d=stack("d"), t=stack("t"),
                      gen=None, active=stack("active"), geom=None)
    labels = {h: torch.stack([d[1][h] for d in decisions]).to(env.device)
              for h in decisions[0][1]}
    w = np.eye(env.params.n_ue, dtype=np.float32)[[d[2] for d in decisions]]
    return states, labels, torch.as_tensor(w, device=env.device)


def _concat(batches):
    """One (states, labels, weights) triple of all stacked episodes."""
    states = EnvState(*(None if batches[0][0][i] is None
                        else torch.cat([b[0][i] for b in batches])
                        for i in range(len(EnvState._fields))))
    labels = {h: torch.cat([b[1][h] for b in batches]) for h in batches[0][1]}
    return states, labels, torch.cat([b[2] for b in batches])


class _DaggerDispatcher:
    """Acts with the sampled entity policy (the deployment mode) while
    labeling every visited state with the oracle's action."""

    def __init__(self, env, agent, oracle, label_raw, seed):
        self.inner = EntityDispatcher(env, agent, deterministic=False, live_channel=True,
                                      seed=seed)
        self.oracle = oracle
        self.label_raw = label_raw
        self.data = []               # (EnvState, label raw dict, ue)

    def __call__(self, core, ue):
        s = stream_env_state(core)
        self.data.append((s, self.label_raw(self.oracle(core, ue)), ue))
        return self.inner(core, ue)


def finetune_streaming(env: MECEnv, agent, sp=None, cfg: StreamTuneConfig = None, *, seed=0,
                       log_cb=None):
    """Adapt a frame-trained entity ``agent`` to the stream scenario ``sp``,
    a :class:`StreamParams` or a sequence of them cycled across each
    iteration's episodes (one fine-tune covers several load points).
    Returns (agent, history); each history row has the iteration's mean
    episode reward and QoS aggregates, measured on the rollouts of the
    actor the row's update starts from, and ``actor_delta``, the largest
    change the update made to a weight. The agent's own actor is not
    modified: the fine-tune trains a copy."""
    sps = sp if isinstance(sp, (list, tuple)) else [sp or StreamParams()]
    cfg = cfg or StreamTuneConfig()
    t0 = float(env.params.t0)
    actor = copy.deepcopy(agent["entity_actor"])
    params = list(actor.parameters())
    opt = adamw_init(params)
    oracle = StreamOracleDispatcher(env, tail_weight=cfg.reward.tail_weight,
                                    energy_weight=cfg.reward.energy_weight)
    label = functools.partial(label_raw, env.action_space, env.params.n_ue)

    history = []
    batches = []                     # DAgger: aggregate across iterations
    best = (-np.inf, agent["entity_actor"])
    ep_seed = seed
    for it in range(cfg.iterations):
        rewards, reports = [], []
        for ep in range(cfg.episodes_per_iter):
            ep_seed += 1
            disp = _DaggerDispatcher(env, {**agent, "entity_actor": actor}, oracle, label,
                                     ep_seed)
            rep = StreamSim(env, disp, sps[ep % len(sps)], seed=ep_seed).run()
            reports.append(rep)
            rewards.append(stream_reward(rep, cfg.reward, t0=t0))
            if disp.data:
                batches.append(_stack_decisions(env, disp.data))
        r_mean = float(np.mean(rewards))
        if r_mean > best[0]:
            best = (r_mean, copy.deepcopy(actor))
        before = [p.detach().clone() for p in params]
        if batches:
            states, raws, w = _concat(batches)
            w = w / float(w.shape[0])            # every stacked row is one decision
            for _ in range(cfg.epochs):
                loss = -_episode_logp(env, actor, states, raws, w)
                adamw_update(torch.autograd.grad(loss, params), opt, params, cfg.lr,
                             weight_decay=0.0)
        delta = torch.stack([(p.detach() - b).abs().max() for p, b in zip(params, before)])
        row = {"iteration": it, "reward_mean": r_mean,
               "miss_rate": float(np.mean([r["miss_rate"] for r in reports])),
               "p99": float(np.mean([r["sojourn_p99"] for r in reports])),
               # 0.0: the update was a no-op (no decisions labeled)
               "actor_delta": float(delta.max())}
        history.append(row)
        if log_cb:
            log_cb(row)

    # the last update is never scored inside the loop: score it, then
    # return the best actor seen (zero-shot weights included)
    rewards = []
    for ep in range(cfg.episodes_per_iter):
        ep_seed += 1
        disp = EntityDispatcher(env, {**agent, "entity_actor": actor}, deterministic=False,
                                live_channel=True, seed=ep_seed)
        rep = StreamSim(env, disp, sps[ep % len(sps)], seed=ep_seed).run()
        rewards.append(stream_reward(rep, cfg.reward, t0=t0))
    if float(np.mean(rewards)) > best[0]:
        best = (float(np.mean(rewards)), actor)
    return {**agent, "entity_actor": best[1]}, history
