"""Policy-driven scheduling of a UE fleet over an edge pool: the scheduling
half of ``examples/collaborative_serve.py`` (its fleet, pool and
``evaluate_policy`` calls), at the port's own configuration.

The fleet alternates two UE kinds: even UEs run qwen3-1.7b's split table on
a phone-class NPU, odd UEs mamba2-1.3b's on a Jetson-class device (both
``transformer_split_table`` at its defaults: seq 128, 4 split points, AE
ratio 4, 8-bit codes). The edge is ``make_edge_pool(n_servers)`` with 2
channels per server, t0 = 0.5 s, beta = 0.47, eval-mode reset (200 tasks
per UE, 50 m). Two agents schedule it, with seeded random weights at the
nets' published widths: the entity actor through the fused pair scorer,
and the flat trunk quantized to ``bits``-bit weight codes (through the
quantize kernel) and served through the fused trunk kernel.

  python -m repro_torch.launch.dispatch_serve                 # N = 1024, E = 3, 64 frames
  python -m repro_torch.launch.dispatch_serve --n-ue 16 --frames 4 --device cpu

Runs on the CUDA card; ``--device cpu`` runs the kernels' plain twins.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import torch

from repro_torch import full_precision_matmuls, resolve_device
from repro_torch.configs import get_config
from repro_torch.core import overhead as oh
from repro_torch.core.fleets import make_edge_pool
from repro_torch.core.split import build_fleet, transformer_split_table
from repro_torch.env.mecenv import MECEnv, make_env_params
from repro_torch.rl import nets
from repro_torch.rl.distill import quantize_flat_trunk
from repro_torch.rl.mahppo import evaluate_policy

# (arch, UE device) of even and odd UEs
UE_KINDS = (("qwen3-1.7b", oh.PHONE_NPU), ("mamba2-1.3b", oh.JETSON_NANO))


def dispatch_fleet(n_ue):
    """The slice's fleet: the UE kinds alternating over ``n_ue`` UEs."""
    tables = [(transformer_split_table(get_config(arch), ue_dev=dev), dev)
              for arch, dev in UE_KINDS]
    picks = [tables[i % len(tables)] for i in range(n_ue)]
    return build_fleet([p for p, _ in picks], [d for _, d in picks])


def dispatch_env(n_ue=1024, n_servers=3, device=None):
    """The slice's env on ``device`` (the card unless the caller asks for
    the CPU; raises when there is no card and no device was given)."""
    device = resolve_device(device)
    return MECEnv(make_env_params(dispatch_fleet(n_ue), n_channels=2, t0=0.5, beta=0.47,
                                  pool=make_edge_pool(n_servers), device=device))


def init_agents(env, seed=0):
    """Seeded random entity actor and f32 flat trunk, made on the CPU (so
    every device gets the same weights) and moved to the env's device."""
    gen = torch.Generator().manual_seed(seed)
    actor = nets.init_entity_actor(gen, env.entity_dims, env.action_space)
    trunk = nets.init_flat_trunk(gen, env.ue_feat_dim, env.action_space)
    return actor.to(env.device), trunk.to(env.device)


@dataclass
class DispatchResult:
    env: MECEnv
    agents: dict                                   # name -> (agent, fused_scorer)
    stats: dict = field(default_factory=dict)      # name -> summary + timing


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_dispatch(*, n_ue=1024, n_servers=3, frames=64, seed=0, bits=8, device=None,
                   log=print) -> DispatchResult:
    """Schedule the fleet for ``frames`` frames with each agent, and report
    completed tasks, t_task, e_task and reward per frame, ms per frame on
    the host clock (work ended by a synchronize) and decisions per second
    (N x frames / time). Launches exactly ``frames`` pair_scorer and
    ``frames`` flat_trunk kernels, and one quantize per trunk layer."""
    dev = resolve_device(device)
    full_precision_matmuls()
    env = dispatch_env(n_ue, n_servers, dev)
    actor, trunk = init_agents(env, seed)
    qtrunk = quantize_flat_trunk(trunk, bits)
    log(f"fleet: {n_ue} UEs ({', '.join(f'{a} on {d.name}' for a, d in UE_KINDS)}), "
        f"{n_servers} servers x {env.n_channels} channels, heads "
        f"{', '.join(env.action_space.names)}; "
        f"entity actor {nets.param_count(actor)} params, "
        f"flat trunk {nets.param_count(trunk)} -> {bits}-bit "
        f"{nets.param_bytes(qtrunk) / 1e3:.1f} kB")
    res = DispatchResult(env, {"entity": ({"entity_actor": actor}, True),
                               f"int{bits} trunk": ({"flat_trunk": qtrunk}, False)})
    for name, (agent, fused) in res.agents.items():
        _sync(dev)
        t0 = time.perf_counter()
        st = evaluate_policy(env, agent, frames=frames, seed=seed, fused_scorer=fused)
        _sync(dev)
        wall = time.perf_counter() - t0
        st["ms_per_frame"] = 1e3 * wall / frames
        st["decisions_per_s"] = n_ue * frames / wall
        res.stats[name] = st
        log(f"{name}: completed {st['completed']:.2f}/frame, t_task {st['t_task']:.6f} s, "
            f"e_task {st['e_task']:.6f} J, reward {st['reward']:.6f}, "
            f"{st['ms_per_frame']:.3f} ms/frame, {st['decisions_per_s']:.0f} decisions/s")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-ue", type=int, default=1024)
    ap.add_argument("--servers", type=int, default=3)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    serve_dispatch(n_ue=args.n_ue, n_servers=args.servers, frames=args.frames,
                   seed=args.seed, bits=args.bits, device=args.device)


if __name__ == "__main__":
    main()
