"""Streaming serve: the trained entity policy as a live dispatcher, the
port's twin of ``examples/streaming_serve.py``.

Trains the pool-generalist entity policy on the frame MEC env (randomized
2-server geometries: MAHPPO, 512 frames over 4 envs an iteration),
streaming-fine-tunes it by DAgger distillation of the occupancy-aware
dispatch oracle (``rl.streaming``, at 6 and 14 tasks/s a UE over 8 s),
then deploys it as the dispatcher of the virtual-time asyncio daemon
(``stream.dispatcher``): mock UE coroutines generate Poisson arrivals with
per-class deadlines, the daemon renders the live queue and occupancy state
as an ``EnvState`` and asks the policy where to split, which server to use
and at what power (sampled, with the channel picked least-loaded at
dispatch time), and mock servers run each task for its Eq. 7/8 service
time. Ends with the QoS report (throughput, deadline-miss rate, p50 / p95
/ p99 sojourn) of the tuned policy, its zero-shot form, nearest-server and
full-local, all on the same arrivals.

The stream is deterministic in ``--seed``: the daemon runs on a virtual
clock and the arrivals come from per-UE numpy streams (the reference's
draws). Training draws come from torch generators, so the trained weights
are not the reference's. Runs on the CUDA card unless ``--device cpu`` is
given.

  PYTHONPATH=src python -m repro_torch.launch.streaming_serve
  PYTHONPATH=src python -m repro_torch.launch.streaming_serve --device cpu --iters 1 \\
      --tune-iters 1 --horizon 2
"""
from __future__ import annotations

import argparse
import time

from repro_torch import full_precision_matmuls, resolve_device
from repro_torch.core.fleets import make_edge_pool, make_mixed_fleet, random_pool_ranges
from repro_torch.env.mecenv import MECEnv, make_env_params
from repro_torch.rl.mahppo import MAHPPOConfig, train_mahppo
from repro_torch.rl.streaming import StreamTuneConfig, finetune_streaming
from repro_torch.stream.adapter import (EntityDispatcher, LocalDispatcher,
                                        NearestServerDispatcher)
from repro_torch.stream.dispatcher import run_daemon
from repro_torch.stream.events import StreamParams

TUNE_SCENARIOS = (StreamParams(rate=6.0, horizon=8.0), StreamParams(rate=14.0, horizon=8.0))


def build_env(n_ue, n_servers, randomized=False, device=None):
    """The mixed fleet on 2 channels of the demo pool, its geometry
    resampled per episode with ``randomized``."""
    ranges = random_pool_ranges(n_servers) if randomized else None
    return MECEnv(make_env_params(make_mixed_fleet(n_ue=n_ue), n_channels=2,
                                  pool=make_edge_pool(n_servers), pool_ranges=ranges,
                                  device=resolve_device(device)))


def train_config(iterations):
    return MAHPPOConfig(iterations=iterations, horizon=512, n_envs=4, reuse=4,
                        entity_policy=True, randomize_pool=True)


def print_report(name, rep):
    print(f"  {name:16s} throughput={rep['throughput']:6.1f}/s  "
          f"miss={rep['miss_rate']:6.1%}  drop={rep['drop_rate']:6.1%}  "
          f"sojourn p50={rep['sojourn_p50']:.3f}s "
          f"p95={rep['sojourn_p95']:.3f}s p99={rep['sojourn_p99']:.3f}s")


def main(argv=None):
    """Run the demo; returns {"agent", "tuned", "env", "history",
    "tune_history", "reports" (name -> QoS report), "cores" (name -> the
    daemon's StreamCore), "per_server", "sp", "seconds" (train, tune and
    each stream's)}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds training AND the stream (deterministic)")
    ap.add_argument("--ues", type=int, default=8)
    ap.add_argument("--servers", type=int, default=2)
    ap.add_argument("--rate", type=float, default=8.0, help="per-UE mean arrivals / second")
    ap.add_argument("--horizon", type=float, default=10.0,
                    help="seconds of arrivals (the daemon then drains)")
    ap.add_argument("--iters", type=int, default=30,
                    help="MAHPPO training iterations (frame env)")
    ap.add_argument("--tune-iters", type=int, default=14,
                    help="streaming DAgger fine-tune iterations (0 = deploy zero-shot)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    args = ap.parse_args(argv)
    full_precision_matmuls()
    seconds = {}

    print(f"training the entity policy: {args.iters} MAHPPO iterations on the frame env "
          f"(N={args.ues}, randomized {args.servers}-server geometries) ...")
    env_rnd = build_env(args.ues, args.servers, randomized=True, device=args.device)
    t0 = time.perf_counter()
    agent, hist = train_mahppo(env_rnd, train_config(args.iters), seed=args.seed)
    seconds["train"] = time.perf_counter() - t0
    print(f"  final frame reward: {hist[-1]['reward_mean']:.4f}")

    env = build_env(args.ues, args.servers, device=args.device)
    tuned, tune_hist = agent, []
    if args.tune_iters:
        print(f"\nstreaming fine-tune: {args.tune_iters} DAgger iterations distilling the "
              "occupancy-aware dispatch oracle (mid-load + saturated scenarios) ...")
        t0 = time.perf_counter()
        tuned, tune_hist = finetune_streaming(
            env, agent, list(TUNE_SCENARIOS), StreamTuneConfig(iterations=args.tune_iters),
            seed=args.seed + 100,
            log_cb=lambda h: print(f"  iter {h['iteration']:2d}: reward={h['reward_mean']:8.3f}"
                                   f"  miss={h['miss_rate']:6.1%}  p99={h['p99']:.3f}s"))
        seconds["tune"] = time.perf_counter() - t0

    sp = StreamParams(rate=args.rate, horizon=args.horizon)
    print(f"\nstreaming {args.horizon:.0f}s of Poisson arrivals at {args.rate:g} tasks/s/UE "
          f"through the asyncio daemon (seed {args.seed}):")
    reports, cores = {}, {}
    log = []
    t0 = time.perf_counter()
    reports["entity (tuned)"], cores["entity (tuned)"] = run_daemon(
        env, EntityDispatcher(env, tuned, deterministic=False, live_channel=True,
                              seed=args.seed),
        sp, seed=args.seed, server_log=log)
    seconds["entity (tuned)"] = time.perf_counter() - t0
    rep = reports["entity (tuned)"]
    per_server = [sum(1 for (_, e, _) in log if e == s) for s in range(env.n_servers)]
    print_report("entity (tuned)", rep)
    print(f"    server task counts: {per_server}  (tasks={rep['tasks']}, "
          f"arrivals={rep['arrivals']})")
    for name, disp in [("entity zero-shot", EntityDispatcher(env, agent)),
                       ("nearest-server", NearestServerDispatcher(env)),
                       ("full-local", LocalDispatcher(env))]:
        t0 = time.perf_counter()
        reports[name], cores[name] = run_daemon(env, disp, sp, seed=args.seed)
        seconds[name] = time.perf_counter() - t0
        print_report(name, reports[name])
    return {"agent": agent, "tuned": tuned, "env": env, "history": hist,
            "tune_history": tune_hist, "reports": reports, "cores": cores,
            "per_server": per_server, "sp": sp, "seconds": seconds}


if __name__ == "__main__":
    main()
