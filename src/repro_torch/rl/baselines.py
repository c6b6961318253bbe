"""Baselines (paper §6.3.1), the port of ``src/repro/rl/baselines.py``:
the full-local policy. The random policy and the fixed-route references of
an edge pool come with a later slice (ROADMAP queue 1)."""
from __future__ import annotations

import torch

from repro_torch.env.mecenv import MECEnv, per_ue


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
