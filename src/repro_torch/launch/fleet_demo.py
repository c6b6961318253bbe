"""Mixed-fleet scheduling, the port's twin of ``examples/collaborative_serve.py
--fleet`` (``run_fleet_demo``).

Two ResNet18 UEs (on a Jetson and on an IoT SoC) and two qwen3-1.7b UEs
(on phone NPUs) share 2 channels of each edge server; MAHPPO learns every
UE's split, channel, power and (on a pool) route. The run prints the fleet
and the pool, the reward every 5 iterations, MAHPPO against the greedy
heuristic (and, on a pool, against nearest-server and load-balanced
routing), the parameter counts, each UE's learned split and route, and
for the entity policy a zero-shot run on an unseen pool of E + 1 servers.

  PYTHONPATH=src python -m repro_torch.launch.fleet_demo
  PYTHONPATH=src python -m repro_torch.launch.fleet_demo --device cpu --iterations 1

With no mode flag the demo is the example's ``--fleet --entity-policy
--fused-scorer --servers 2``: the entity actor over randomized pool
geometry, its route scorer through the ``pair_scorer`` kernel forward and
backward. The example's flags pick the other modes (``--fleet`` alone: the
per-UE actors on one server; ``--shared-policy``; ``--entity-policy``
without the kernel; ``--servers E``; ``--n-ue N``). ``--churn`` (or
``--churn-rate`` / ``--leave-rate``, defaults 0.2 and 0.1) makes the fleet
dynamic: the demo prints a 24-frame full-local membership trace from a
fixed seed, scores greedy, nearest and load-balanced on its last non-empty
membership snapshot and reports the mean fleet size over the evaluation.

``--llm`` schedules the mixed CNN + LLM-decode fleet (two ResNet18 UEs and
one qwen3-1.7b decode UE a context rung, 256 / 1024 / 4096, whose payload
carries the UE-side KV cache) against a thin multi-tenant v5e slice and an
edge-GPU tier, with 2-second frames and no pool randomization, and prints
whether the context-length shift (short rungs offload, the long rung stays
local or splits later) has emerged. ``--distill`` then distills the entity
teacher into the flat trunk on the static pool (``rl.distill``), quantizes
it to int8 (three ``quantize`` launches), scores it through the
``flat_trunk`` kernel (one launch an eval frame) against the teacher, and
closes with a batch-1 forward readout of the teacher, the f32 student and
the int8 student (best of 20 after one warm call). Runs on the CUDA card
unless ``--device cpu`` is given.

``--n-shards K`` trains with the envs sharded over K ranks of a
``torch.distributed`` world (``launch.mesh.spawn``): each rank steps its
share of the envs and every rank runs the same update on the gathered
trajectory. Only rank 0 prints. ``--backend nccl`` (the default on the
card) runs one rank a card and raises with fewer cards than K; ``--backend
gloo`` runs every rank on the one device, card 0 or the CPU (the only
backend with ``--device cpu``).

  PYTHONPATH=src python -m repro_torch.launch.fleet_demo --device cpu --iterations 1 --distill
  PYTHONPATH=src python -m repro_torch.launch.fleet_demo --device cpu --iterations 1 --llm
  PYTHONPATH=src python -m repro_torch.launch.fleet_demo --device cpu --iterations 1 \
      --n-shards 2 --backend gloo
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from repro_torch import full_precision_matmuls, resolve_device
from repro_torch.configs import ARCH_IDS
from repro_torch.core import overhead as oh
from repro_torch.core.fleets import (LLM_CTX_RUNGS, EdgePool, make_edge_pool,
                                     make_llm_mixed_fleet, make_mixed_fleet, random_pool_ranges)
from repro_torch.env.mecenv import MECEnv, make_env_params
from repro_torch.launch.mesh import spawn
from repro_torch.rl import nets
from repro_torch.rl.baselines import load_aware_eval, nearest_server_eval
from repro_torch.rl.distill import DistillConfig, distill_entity_policy, quantize_flat_trunk
from repro_torch.rl.heuristics import greedy_eval
from repro_torch.rl.mahppo import MAHPPOConfig, evaluate_policy, init_agent, train_mahppo

DISTILL = DistillConfig(iterations=2, frames=48, epochs=120)   # the example's
READOUT_CALLS = 20                 # timed batch-1 forwards a network, after one warm call


def fleet_config(iterations=15, *, shared_policy=False, entity_policy=False,
                 randomize_pool=False, fused_scorer=False, n_shards=1):
    """The example's training settings."""
    return MAHPPOConfig(iterations=iterations, horizon=512, n_envs=4, reuse=4,
                        shared_policy=shared_policy, entity_policy=entity_policy,
                        randomize_pool=randomize_pool, fused_scorer=fused_scorer,
                        n_shards=n_shards)


def fleet_env(fleet, pool, *, t0=0.5, randomize=False, device=None, churn_rate=0.0,
              leave_rate=0.0):
    """The demo's env: ``fleet`` on 2 channels of ``pool`` (None: the
    paper's one server), frames of ``t0`` seconds, the pool's geometry
    resampled per episode with ``randomize`` (ranges
    ``random_pool_ranges``), dynamic with a nonzero ``churn_rate`` or
    ``leave_rate``."""
    return MECEnv(make_env_params(
        fleet, n_channels=2, t0=t0, churn_rate=churn_rate, leave_rate=leave_rate, pool=pool,
        pool_ranges=random_pool_ranges(pool.n_servers) if randomize else None,
        device=resolve_device(device)))


def llm_pool():
    """The ``--llm`` pool: a thin multi-tenant v5e slice (2.5 % of its
    peak) at the cell center and an edge GPU at 1.4 x the distance."""
    return EdgePool((oh.ServerProfile.from_device(oh.TPU_V5E, utilization=0.025),
                     oh.ServerProfile.from_device(oh.EDGE_GPU, dist_scale=1.4)))


def membership_trace(env, frames=24, seed=7):
    """A full-local rollout from a random reset (generator seeded with
    ``seed``) until the episode ends or ``frames`` frames: each frame's
    membership after the step, as a string of '#' (active) and '.'
    (standby), and the last non-empty membership (the reset's if none)."""
    dev, n = env.device, env.params.n_ue
    s = env.reset(torch.Generator(device=dev).manual_seed(seed))
    acts = {"split": torch.full((n,), env.n_actions_b - 1, dtype=torch.int32, device=dev),
            "channel": torch.zeros((n,), dtype=torch.int32, device=dev),
            "power": torch.full((n,), 0.05, device=dev)}
    if env.multi_server:
        acts["route"] = torch.zeros((n,), dtype=torch.int32, device=dev)
    snapshot = s.active.cpu().numpy()
    rows = []
    for _ in range(frames):
        s, _, done, _ = env.step(s, acts)
        if bool(done):
            break                      # the state after done is the auto-reset fleet
        active = s.active.cpu().numpy()
        rows.append("".join("#" if a else "." for a in active))
        if active.any():
            snapshot = active
    return rows, snapshot


def run_fleet_demo(arch="qwen3-1.7b", iterations=15, *, n_servers=1, shared_policy=False,
                   entity_policy=False, n_ue=4, fused_scorer=False, device=None,
                   churn_rate=0.0, leave_rate=0.0, llm=False, distill=False, n_shards=1):
    """Train and score the demo (with ``n_shards`` > 1 on every rank of a
    world of that many). Returns {"history", "mahppo", "greedy",
    "nearest", "loadbal", "zero_shot", "membership", "snapshot", "agent",
    "env", "seconds", "splits", "llm_shift", "distill"} (entries that do
    not apply are None)."""
    dev = resolve_device(device)
    frame_s = 0.5
    if llm:
        # 2-second frames, so the ctx-4096 rung's full-local run spans frames
        fleet, pool, frame_s = make_llm_mixed_fleet(arch), llm_pool(), 2.0
        print(f"LLM context rungs: {LLM_CTX_RUNGS} (f_bits grows with context: the KV cache "
              f"rides the boundary payload)")
    else:
        fleet = make_mixed_fleet(arch, n_ue=n_ue)
        pool = make_edge_pool(n_servers) if n_servers > 1 else None
    print("fleet:")
    for i, (name, prof) in enumerate(zip(fleet.names, fleet.profiles)):
        print(f"  ue{i}: {name:14s} on {prof.name:12s} (P_compute={prof.p_compute:.1f} W, "
            f"{int(fleet.feasible[i].sum())}/{fleet.n_actions} feasible actions)")
    if pool is not None:
        print("edge pool:")
        for e, srv in enumerate(pool.servers):
            print(f"  srv{e}: {srv.name:10s} dist x{srv.dist_scale:.1f}  bw x{srv.bw_scale:.1f}  "
                f"edge_speed={srv.edge_speed / 1e12:.1f} TFLOP/s")
    randomize = entity_policy and pool is not None and not llm
    env = fleet_env(fleet, pool, t0=frame_s, randomize=randomize, device=dev,
                    churn_rate=churn_rate, leave_rate=leave_rate)
    print(f"action space: {', '.join(env.action_space.names)}")
    trace = snapshot = None          # the baselines' membership on a dynamic fleet
    if env.dynamic:
        print(f"dynamic fleet: join intensity {churn_rate}, leave prob {leave_rate}/frame")
        trace, snapshot = membership_trace(env)
        print("  membership (one column per UE, # active / . standby):")
        for t, row in enumerate(trace):
            if t % 4 == 0:
                print(f"    frame {t:2d}: {row}")
    mode = "entity-set actor, per-server route scorer" if entity_policy \
        else "weight-shared actor" if shared_policy else "per-UE actors"
    extra = " over randomized pool geometries" if randomize else ""
    print(f"\ntraining MAHPPO ({mode}) on the mixed fleet{extra} ({iterations} iterations)...")
    if fused_scorer:
        print("  fused pair-scorer kernel path (observe_entities_raw)")
    if n_shards > 1:
        print(f"  rollouts sharded over {n_shards} ranks ({torch.distributed.get_backend()}, "
              f"{dev})")
    cfg = fleet_config(iterations, shared_policy=shared_policy, entity_policy=entity_policy,
                       randomize_pool=randomize, fused_scorer=fused_scorer, n_shards=n_shards)
    t0 = time.perf_counter()
    agent, hist = train_mahppo(env, cfg, seed=0, log_cb=lambda r: print(
        f"  iter {r['iteration']:3d} reward={r['reward_mean']:.4f}")
        if r["iteration"] % 5 == 0 else None)
    seconds = time.perf_counter() - t0
    ev = evaluate_policy(env, agent, frames=64)
    # greedy on the traced membership snapshot, so both columns score a
    # churned fleet
    gr = greedy_eval(env, active=snapshot)
    beta = env.params.beta
    out = {"history": hist, "mahppo": ev, "greedy": gr, "nearest": None, "loadbal": None,
           "zero_shot": None, "membership": trace, "snapshot": snapshot, "agent": agent,
           "env": env, "seconds": seconds, "llm_shift": None, "distill": None}
    if env.dynamic:
        print(f"\nmean fleet size over eval: {ev['n_active']:.2f} of {env.params.n_ue} UEs"
            + ("" if snapshot is None else
               f"; greedy scored on {int(snapshot.sum())} active UEs"))
    print(f"\nMAHPPO : latency {1e3 * ev['t_task']:.1f} ms  energy {1e3 * ev['e_task']:.1f} mJ  "
        f"overhead {ev['t_task'] + beta * ev['e_task']:.4f}")
    print(f"greedy : latency {1e3 * gr['t_task']:.1f} ms  energy {1e3 * gr['e_task']:.1f} mJ  "
        f"overhead {gr['overhead']:.4f}  (per-UE b={gr['b']}"
        + (f", route={gr['route']}" if "route" in gr else "") + ")")
    if env.multi_server:
        out["nearest"] = near = nearest_server_eval(env, active=snapshot)
        out["loadbal"] = load = load_aware_eval(env, active=snapshot)
        print(f"nearest: overhead {near['overhead']:.4f}  (route={near['route']})")
        print(f"loadbal: overhead {load['overhead']:.4f}  (route={load['route']})")

    if (shared_policy or entity_policy) and n_ue <= 16:
        n_pol = nets.param_count(agent.get("actor") or agent["entity_actor"])
        n_per_ue = nets.param_count(init_agent(torch.Generator().manual_seed(0), env)["actors"])
        kind = "entity" if entity_policy else "shared"
        print(f"\nactor parameters: {n_pol} {kind} (O(1) in fleet size"
            + (" AND pool size" if entity_policy else "")
            + f") vs {n_per_ue} for per-UE actors at N={env.params.n_ue}")

    # learned per-UE decisions at the eval state
    space, n = env.action_space, env.params.n_ue
    s = env.reset(eval_mode=True)
    with torch.inference_mode():
        if entity_policy:
            masks = space.broadcast_masks(env.action_masks(), n, device=dev)
            dist = nets.entity_actor_forward(agent["entity_actor"], space,
                                             env.observe_entities(s), masks)
        elif shared_policy:
            masks = space.broadcast_masks(env.action_masks(), n, device=dev)
            dist = nets.shared_actor_forward(agent["actor"], space, env.observe_per_ue(s),
                                             masks)
        else:
            masks = env.action_masks()
            dist = nets.actor_forward(agent["actors"], space, env.observe(s), masks)
        a_star = {k: v.cpu().numpy() for k, v in space.mode(dist, masks).items()}
    for i, b in enumerate(a_star["split"]):
        kind = ("raw offload" if b == 0 else
                "full local" if b == env.n_actions_b - 1 else f"split b={b}")
        where = f" -> srv{int(a_star['route'][i])}" \
            if env.multi_server and b != env.n_actions_b - 1 else ""
        print(f"  ue{i} ({fleet.names[i]}): {kind}{where}")
    out["splits"] = a_star["split"]
    if env.multi_server:
        counts = np.bincount(a_star["route"], minlength=env.n_servers)
        print("  learned route distribution: "
            + ", ".join(f"srv{e}={int(c)}" for e, c in enumerate(counts)))
    if llm:
        b_llm = a_star["split"][-len(LLM_CTX_RUNGS):]
        local = env.n_actions_b - 1
        offl = b_llm[:-1][b_llm[:-1] != local]
        out["llm_shift"] = shift = bool(offl.size > 0 and (b_llm[-1] == local
                                                             or b_llm[-1] > offl.min()))
        print(f"  context-length shift (short rungs offload, ctx{LLM_CTX_RUNGS[-1]} stays "
              f"local/later): {'YES' if shift else 'not yet at this budget'}")

    # the entity policy's parameters do not depend on the pool size: the
    # same agent on an E + 1-server pool, zero-shot
    if entity_policy and env.multi_server and n_servers < 3 and not llm:
        env_big = MECEnv(make_env_params(fleet, n_channels=2, pool=make_edge_pool(n_servers + 1),
                                         device=dev))
        ev_big = evaluate_policy(env_big, agent, frames=64)
        near_big = nearest_server_eval(env_big)
        ovh_big = ev_big["t_task"] + beta * ev_big["e_task"]
        out["zero_shot"] = {"mahppo": ev_big, "overhead": ovh_big, "nearest": near_big}
        print(f"\nzero-shot on an UNSEEN {n_servers + 1}-server pool (route head is E-free): "
            f"entity overhead {ovh_big:.4f} vs nearest-server {near_big['overhead']:.4f} "
            f"[{'BEATS' if ovh_big <= near_big['overhead'] else 'LOSES'}]")
    if distill:
        # the deployment serves one pool: the static one
        env_d = fleet_env(fleet, pool, t0=frame_s, device=dev) if randomize else env
        out["distill"] = distill_demo(env_d, agent)
    return out


def distill_demo(env, agent):
    """Distill the entity ``agent`` into the flat trunk on the static
    ``env`` (``DISTILL``, seed 1), quantize it, score the int8 student
    against the teacher over 64 eval frames and time one batch-1 forward
    of each network. Returns {"history", "student", "qstudent", "params",
    "overhead", "forward_us", "seconds"}."""
    print("\ndistilling into the serve-small flat trunk (rl.distill; fixed fleet, fixed pool)...")
    t0 = time.perf_counter()
    student, hist = distill_entity_policy(
        env, agent, DISTILL, seed=1, log_cb=lambda r: print(
            f"  round {r['iteration']}: dataset {r['states']} states  loss {r['loss']:.4f}  "
            f"mode agreement {r['agreement']:.2f}"))
    seconds = time.perf_counter() - t0
    qstudent = quantize_flat_trunk(student)
    params = {"teacher": nets.param_count(agent["entity_actor"]),
              "student": nets.param_count(student),
              "teacher_bytes": nets.param_bytes(agent["entity_actor"]),
              "f32_bytes": nets.param_bytes(student), "int8_bytes": nets.param_bytes(qstudent)}
    print(f"  teacher {params['teacher']} params ({params['teacher_bytes'] / 1e3:.1f} kB) -> "
          f"student {params['student']} ({100 * params['student'] / params['teacher']:.1f}%); "
          f"int8 serving weights {params['int8_bytes'] / 1e3:.1f} kB vs f32 "
          f"{params['f32_bytes'] / 1e3:.1f} kB")
    beta = env.params.beta
    ev_t = evaluate_policy(env, agent, frames=64)
    ev_q = evaluate_policy(env, {"flat_trunk": qstudent}, frames=64)
    ovh = {"teacher": ev_t["t_task"] + beta * ev_t["e_task"],
           "int8": ev_q["t_task"] + beta * ev_q["e_task"]}
    print(f"  int8 student overhead {ovh['int8']:.4f} vs teacher {ovh['teacher']:.4f} "
          f"(ratio {ovh['int8'] / ovh['teacher']:.2f})")

    # the per-task cost the dispatcher pays on the streaming path: one
    # batch-1 policy forward
    space, dev = env.action_space, env.device
    s0 = env.reset(eval_mode=True)
    masks = space.broadcast_masks(env.action_masks(), env.params.n_ue, device=dev)
    rows, ents = env.observe_per_ue(s0), env.observe_entities(s0)
    cells = (("entity teacher", lambda: nets.entity_actor_forward(agent["entity_actor"], space,
                                                                  ents, masks)),
             ("distilled f32", lambda: nets.flat_trunk_forward(student, space, rows, masks)),
             ("distilled int8", lambda: nets.flat_trunk_forward(qstudent, space, rows, masks)))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def best_us(fn):
        fn()
        sync()                     # warm
        best = float("inf")
        for _ in range(READOUT_CALLS):
            t1 = time.perf_counter()
            fn()
            sync()
            best = min(best, time.perf_counter() - t1)
        return best * 1e6

    print(f"  batch-1 dispatch forward (best of {READOUT_CALLS}):")
    forward_us = {}
    with torch.inference_mode():
        for name, fn in cells:
            forward_us[name] = best_us(fn)
            print(f"    {name:14s}: {forward_us[name]:8.1f} us")
    return {"history": hist, "student": student, "qstudent": qstudent, "params": params,
            "overhead": ovh, "forward_us": forward_us, "seconds": seconds}


def _sharded_rank(rank, device, kwargs):
    """One rank of ``--n-shards``: the demo on ``device``, printed by rank
    0 only; its result without the agent and the env."""
    with open(os.devnull, "w") as null, \
            contextlib.redirect_stdout(null) if rank else contextlib.nullcontext():
        out = run_fleet_demo(device=device, **kwargs)
    return {k: v for k, v in out.items() if k not in ("agent", "env")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=ARCH_IDS)
    ap.add_argument("--fleet", action="store_true",
                    help="the example's fleet demo flag (alone: per-UE actors, one server)")
    ap.add_argument("--servers", type=int, default=1, metavar="E")
    ap.add_argument("--shared-policy", action="store_true")
    ap.add_argument("--entity-policy", action="store_true")
    ap.add_argument("--fused-scorer", action="store_true",
                    help="the entity route scorer through the pair_scorer kernel "
                         "(implies --entity-policy)")
    ap.add_argument("--n-ue", type=int, default=4, metavar="N")
    ap.add_argument("--iterations", type=int, default=15)
    ap.add_argument("--churn", action="store_true",
                    help="a dynamic fleet: UEs join and leave mid-episode (also implied by "
                         "--churn-rate / --leave-rate)")
    ap.add_argument("--churn-rate", type=float, default=None,
                    help="Poisson join intensity a standby slot a frame (default 0.2 when "
                         "churning)")
    ap.add_argument("--leave-rate", type=float, default=None,
                    help="per-frame departure probability of an active UE (default 0.1 "
                         "when churning)")
    ap.add_argument("--llm", action="store_true",
                    help="the mixed CNN + LLM-decode fleet on the thin v5e + edge-GPU pool "
                         "(implies --entity-policy)")
    ap.add_argument("--distill", action="store_true",
                    help="after training, distill the entity teacher into the int8 flat "
                         "trunk and time a batch-1 forward (implies --entity-policy; not "
                         "with --churn)")
    ap.add_argument("--n-shards", type=int, default=1, metavar="K",
                    help="shard the envs over K ranks of torch.distributed")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the ranks' backend with --n-shards: nccl (default on the card) runs "
                         "one rank a card, gloo every rank on the one device (the only "
                         "backend with --device cpu)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    args = ap.parse_args(argv)
    churn = args.churn or args.churn_rate is not None or args.leave_rate is not None
    if args.distill and churn:
        ap.error("--distill targets a fixed deployment fleet; it cannot combine with --churn")
    if args.n_shards < 1:
        ap.error("--n-shards must be at least 1")
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    backend = args.backend or ("gloo" if cpu else "nccl")
    if args.entity_policy and args.shared_policy:
        ap.error("pick one of --entity-policy / --shared-policy")
    if args.fused_scorer and args.shared_policy:
        ap.error("--fused-scorer fuses the entity route scorer; it cannot combine with "
                 "--shared-policy")
    if not (args.fleet or args.servers > 1 or args.shared_policy or args.entity_policy
            or args.fused_scorer or args.n_ue != 4):     # --churn, --llm and --distill alone
        args.fused_scorer, args.servers = True, 2          # run the slice's mode
    if (args.llm or args.distill) and args.shared_policy:
        ap.error("--llm and --distill need the entity policy; they cannot combine with "
                 "--shared-policy")
    if args.fused_scorer or args.llm or args.distill:
        args.entity_policy = True
    if args.entity_policy and args.servers < 2:
        args.servers = 2           # the route scorer needs a pool to score
    full_precision_matmuls()
    kwargs = dict(
        arch=args.arch, iterations=args.iterations, n_servers=args.servers,
        shared_policy=args.shared_policy, entity_policy=args.entity_policy, n_ue=args.n_ue,
        fused_scorer=args.fused_scorer,
        churn_rate=(0.2 if args.churn_rate is None else args.churn_rate) if churn else 0.0,
        leave_rate=(0.1 if args.leave_rate is None else args.leave_rate) if churn else 0.0,
        llm=args.llm, distill=args.distill)
    if args.n_shards == 1:
        return run_fleet_demo(device=args.device, **kwargs)
    fleet_config(n_shards=args.n_shards)     # n_envs must split over the ranks: raises first
    return spawn(_sharded_rank, args.n_shards, backend, dict(kwargs, n_shards=args.n_shards),
                 device=args.device)[0]


if __name__ == "__main__":
    main()
