"""Policy evaluation of the scheduler, the port of
``src/repro/rl/mahppo.py::evaluate_policy``. MAHPPO training comes with
the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.env.mecenv import MECEnv
from repro_torch.rl import nets

_SUMMARY = ("reward", "t_sum", "e_sum", "w_sum", "completed", "n_active", "done")


@torch.inference_mode()
def evaluate_policy(env: MECEnv, agent, *, frames=64, seed=0, deterministic=True,
                    fused_scorer=False, n_envs=1, n_shards=1, trace=None):
    """Run one eval-mode episode of ``frames`` frames; report the per-task
    latency and energy (Eq. 7/8, weighted by completions) and the mean
    reward, completions, active UEs and done flag per frame.

    ``agent`` is an entity agent ({"entity_actor": ...}, on
    ``observe_entities``, or on ``observe_entities_raw`` through the fused
    pair scorer with ``fused_scorer``) or a distilled trunk ({"flat_trunk":
    f32 MLP or its int8 form}, on ``observe_per_ue``). The reference's
    ``lax.scan`` is a loop over frames with no host sync inside; the
    summary is read once at the end. ``deterministic=False`` samples
    actions from a generator seeded with ``seed + 1`` (the env's, seeded
    with ``seed``, drives its auto-resets). ``trace``, a list, receives each
    frame's {"dist", "actions"}."""
    if n_envs != 1 or n_shards != 1:
        raise NotImplementedError("batched and sharded evaluation (n_envs, n_shards > 1) "
                                  "come with the launch and sharding slice")
    if "actor" in agent or "actors" in agent:
        raise NotImplementedError("the per-UE and shared actors come with the actors "
                                  "slice")
    entity = "entity_actor" in agent
    if not entity and "flat_trunk" not in agent:
        raise ValueError(f"unknown agent with keys {sorted(agent)}")
    if fused_scorer and not entity:
        raise ValueError("fused_scorer needs an entity agent")
    space, n_ue, dev = env.action_space, env.params.n_ue, env.device
    obs_entities = env.observe_entities_raw if fused_scorer else env.observe_entities
    gen_act = torch.Generator(device=dev).manual_seed(seed + 1)
    s = env.reset(torch.Generator(device=dev).manual_seed(seed), eval_mode=True)
    masks = space.broadcast_masks(env.action_masks(s), n_ue, device=dev)
    rows = []
    for _ in range(frames):
        if entity:
            dist = nets.entity_actor_forward(agent["entity_actor"], space, obs_entities(s), masks)
        else:
            dist = nets.flat_trunk_forward(agent["flat_trunk"], space, env.observe_per_ue(s),
                                           masks)
        actions = space.mode(dist, masks) if deterministic \
            else space.sample(gen_act, dist, masks)
        phys = space.execute(actions)
        s2, reward, done, info = env.step(s, phys)
        t_task, e_task = env.task_overhead(s, phys)
        # completion-weighted per-task overhead; a tensor numerator, since
        # scalar / tensor would multiply by 1 / t_task
        w = torch.where(t_task > 0, torch.full_like(t_task, env.params.t0) / t_task, 0.0) \
            * (s.k > 0) * s.active
        rows.append(torch.stack([reward, (t_task * w).sum(), (e_task * w).sum(), w.sum(),
                                 info["completed"], info["n_active"].to(torch.float32),
                                 done.to(torch.float32)]))
        if trace is not None:
            trace.append({"dist": dist, "actions": actions})
        s = s2
    out = torch.stack(rows).cpu().numpy()
    res = {k: float(out[:, i].mean()) for i, k in enumerate(_SUMMARY)}
    res["t_task"] = res.pop("t_sum") / max(res["w_sum"], 1e-9)
    res["e_task"] = res.pop("e_sum") / max(res.pop("w_sum"), 1e-9)
    return res
