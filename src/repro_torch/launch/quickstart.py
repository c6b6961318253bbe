"""Quickstart: the paper's pipeline end to end on a reduced setup, the
port's twin of ``examples/quickstart.py``.

1. Build a split plan for an architecture (layer-indivisible tasks,
   AE-compressed boundary features, paper §2-3).
2. Train a MAHPPO scheduler (per-UE actors) for 5 UEs sharing 2 channels
   (paper §5).
3. Compare against full-local inference (paper §6).

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--arch qwen3-1.7b]
  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu --iterations 2

Runs on the CUDA card unless ``--device cpu`` is given (and raises when
there is no card and no device was asked for).
"""
from __future__ import annotations

import argparse

from repro_torch import full_precision_matmuls, resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.split import transformer_split_table
from repro_torch.env.mecenv import MECEnv, make_env_params
from repro_torch.rl.baselines import local_policy_eval
from repro_torch.rl.mahppo import MAHPPOConfig, evaluate_policy, train_mahppo


def quickstart_env(arch="qwen3-1.7b", n_ue=5, device=None):
    """The example's env: the arch's split table, ``n_ue`` UEs on 2
    channels, t0 = max(0.5, round(10 t_full, 1)) and beta = t_full /
    e_full. Returns (plan, env)."""
    plan = transformer_split_table(get_config(arch))
    t_full = float(plan.t_local[-1])
    e_full = float(plan.e_local[-1])
    env = MECEnv(make_env_params(plan, n_ue=n_ue, n_channels=2,
                                 t0=max(0.5, round(10 * t_full, 1)),
                                 beta=t_full / max(e_full, 1e-9), device=device))
    return plan, env


def main(argv=None):
    """Returns {"mahppo": eval dict, "local": eval dict, "history": the
    training records, "beta": float}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=ARCH_IDS)
    ap.add_argument("--iterations", type=int, default=30)
    ap.add_argument("--n-ue", type=int, default=5)
    ap.add_argument("--horizon", type=int, default=1024,
                    help="frames collected an iteration, over 8 envs")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    full_precision_matmuls()

    plan, env = quickstart_env(args.arch, args.n_ue, device)
    print(f"split plan for {args.arch}:")
    for b in range(plan.n_actions):
        print(f"  b={b}: t_local={1e3*plan.t_local[b]:8.1f}ms "
              f"payload={plan.f_bits[b]/1e3:9.1f}kbit "
              f"feasible={bool(plan.feasible[b])}")

    print(f"\ntraining MAHPPO ({args.iterations} iterations) on {device}...")
    ppo = MAHPPOConfig(iterations=args.iterations, horizon=args.horizon, n_envs=8)
    agent, hist = train_mahppo(env, ppo, seed=0,
                               log_cb=lambda r: print(
                                   f"  iter {r['iteration']:3d} "
                                   f"reward={r['reward_mean']:.4f}", flush=True)
                               if r["iteration"] % 5 == 0 else None)

    ev = evaluate_policy(env, agent, frames=64)
    lo = local_policy_eval(env, frames=64)
    beta = float(env.params.beta)
    ovh = ev["t_task"] + beta * ev["e_task"]
    lovh = lo["t_task"] + beta * lo["e_task"]
    print(f"\nMAHPPO : latency {1e3*ev['t_task']:.1f} ms  "
          f"energy {1e3*ev['e_task']:.1f} mJ  overhead {ovh:.4f}")
    print(f"Local  : latency {1e3*lo['t_task']:.1f} ms  "
          f"energy {1e3*lo['e_task']:.1f} mJ  overhead {lovh:.4f}")
    print(f"overhead reduction: {100*(1-ovh/lovh):.0f}%")
    return {"mahppo": ev, "local": lo, "history": hist, "beta": beta}


if __name__ == "__main__":
    main()
