"""Baselines (paper §6.3.1), the port of ``src/repro/rl/baselines.py``:
full-local and random policies, and on an edge pool two fixed-routing
references:

* nearest-server greedy: every UE offloads at its clean-channel-best split
  but routes to the closest server, so the fleet piles onto one server's
  channels;
* load-aware round-robin: the same per-UE splits with UEs dealt across
  servers round-robin.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.env.mecenv import MECEnv, per_ue
from repro_torch.rl.heuristics import (_active, _clean_cost_table, _joint_overhead,
                                       _round_robin_channels, _scores)


def _act(env: MECEnv, b, c, p, route=None):
    """The env's actions dict, with a default route head on a pool."""
    a = {"split": b, "channel": c, "power": p}
    if env.multi_server:
        a["route"] = torch.zeros_like(b) if route is None else route
    return a


@torch.inference_mode()
def local_policy_eval(env: MECEnv, *, frames=64, seed=0):
    """Always run fully locally (b = B+1, the last action of every UE).
    One eval-mode episode of ``frames`` frames on the env's device, read
    back once at the end; the per-task means cover active UEs only."""
    dev, n = env.device, env.params.n_ue
    b = torch.full((n,), env.n_actions_b - 1, dtype=torch.int32, device=dev)
    c = torch.zeros((n,), dtype=torch.int32, device=dev)
    p = torch.full((n,), 0.01, dtype=torch.float32, device=dev)
    s = env.reset(torch.Generator(device=dev).manual_seed(seed), eval_mode=True)
    t_task = per_ue(env.params.l_new, b)
    e_task = t_task * env.params.p_compute
    rows = []
    for _ in range(frames):
        s2, reward, _, info = env.step(s, _act(env, b, c, p))
        act = s.active.to(torch.float32)
        n_act = torch.clamp(act.sum(), min=1.0)
        rows.append(torch.stack([reward, (t_task * act).sum() / n_act,
                                 (e_task * act).sum() / n_act, info["completed"]]))
        s = s2
    out = torch.stack(rows).mean(dim=0).tolist()
    return dict(zip(("reward", "t_task", "e_task", "completed"), out))


@torch.inference_mode()
def random_policy_eval(env: MECEnv, *, frames=64, seed=0, actions=None, trace=None):
    """Uniform over each UE's own feasible splits, channels, powers in
    [0.01, p_max] and, on a pool, servers; one eval-mode episode of
    ``frames`` frames, read back once at the end. The draws come from a
    generator seeded with ``seed + 1`` (the env's, seeded with ``seed``,
    drives its auto-resets), so they are not the reference's; ``actions``,
    a list of per-frame action dicts, replaces them (so a test can feed the
    reference's), and ``trace``, a list, receives each frame's actions.
    On a dynamic fleet the state's mask pins inactive UEs to full-local."""
    dev, n = env.device, env.params.n_ue
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    s = env.reset(torch.Generator(device=dev).manual_seed(seed), eval_mode=True)
    weights = env.action_masks(s)["split"].to(torch.float32)
    rows = []
    for t in range(frames):
        if env.dynamic:      # inactive UEs take only full-local
            weights = env.action_masks(s)["split"].to(torch.float32)
        if actions is not None:
            a = actions[t]
        else:
            a = {"split": torch.multinomial(weights, 1, generator=gen)[:, 0].to(torch.int32),
                 "channel": torch.randint(0, env.n_channels, (n,), generator=gen, device=dev,
                                          dtype=torch.int32),
                 "power": 0.01 + torch.rand((n,), generator=gen, device=dev)
                 * (env.params.p_max - 0.01)}
            if env.multi_server:
                a["route"] = torch.randint(0, env.n_servers, (n,), generator=gen, device=dev,
                                           dtype=torch.int32)
        if trace is not None:
            trace.append(a)
        s, reward, _, info = env.step(s, _act(env, a["split"], a["channel"], a["power"],
                                              a.get("route")))
        rows.append(torch.stack([reward, info["completed"]]))
    out = torch.stack(rows).mean(dim=0).tolist()
    return dict(zip(("reward", "completed"), out))


def _fixed_route_eval(env: MECEnv, route, *, d=50.0, active=None):
    """Greedy per-UE splits under a fixed routing: each UE takes its best
    clean-channel split on its assigned server, channels round-robin within
    each server, p_max; then scored jointly with interference and server
    sharing. ``active`` (N,) bool: the others neither transmit nor enter
    the means."""
    prm = env.params
    n = prm.n_ue
    act = _active(n, active)
    cost = _clean_cost_table(env, d)                  # (N, B+2, E)
    b = [int(cost[ue, :, route[ue]].argmin()) for ue in range(n)]
    c = _round_robin_channels(route, env.n_channels)
    t, e = _joint_overhead(env, b, c, [float(prm.p_max)] * n, [d] * n, active=act, route=route)
    return {"b": b, "route": list(route), **_scores(env, act, t, e)}


def nearest_server_eval(env: MECEnv, *, d=50.0, active=None):
    """Every UE routes to the closest server (least dist_scale) and
    offloads at its clean-channel-best split there."""
    if not env.multi_server:
        raise ValueError("nearest_server_eval needs a multi-server env")
    e_near = int(np.argmin(env.params.server_dist.cpu().numpy()))
    return _fixed_route_eval(env, [e_near] * env.params.n_ue, d=d, active=active)


def load_aware_eval(env: MECEnv, *, d=50.0, active=None):
    """Round-robin load balancing: UE i routes to server i mod E, splits
    re-optimized per assigned server."""
    if not env.multi_server:
        raise ValueError("load_aware_eval needs a multi-server env")
    return _fixed_route_eval(env, [i % env.n_servers for i in range(env.params.n_ue)], d=d,
                             active=active)
