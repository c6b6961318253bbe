"""Fleet and edge-pool helpers, the port's copy of the analytic half of
``src/repro/core/fleets.py`` (numpy only): the normalisers and feature
builders the env serves to the policies, the demo edge pools and the
mixed CNN + transformer fleet and the mixed CNN + LLM-decode one.

Every per-UE feature is a normalized scalar summary, never a raw table, so
feature widths do not depend on the fleet size N, the action width B_max
or the pool size E.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core import overhead as oh
from repro_torch.core.cnn import make_resnet18
from repro_torch.core.split import (FleetPlan, build_fleet, cnn_split_table,
                                    llm_decode_split_table, transformer_split_table)


def make_mixed_fleet(arch: str = "qwen3-1.7b", n_ue: int = 4) -> FleetPlan:
    """ResNet18 on a Jetson, ResNet18 on an IoT-class SoC, and two
    transformer UEs (``arch``) on phone NPUs, each split table built for
    the device that runs it; ``n_ue`` cycles that 4-UE mix."""
    from repro_torch.configs import get_config
    cnn = make_resnet18(101)
    tcfg = get_config(arch)
    base = [(cnn_split_table(cnn, 224, dev=oh.JETSON_NANO), oh.JETSON_NANO),
            (cnn_split_table(cnn, 224, dev=oh.IOT_SOC), oh.IOT_SOC),
            (transformer_split_table(tcfg, ue_dev=oh.PHONE_NPU), oh.PHONE_NPU),
            (transformer_split_table(tcfg, ue_dev=oh.PHONE_NPU), oh.PHONE_NPU)]
    picks = [base[i % len(base)] for i in range(n_ue)]
    return build_fleet([p for p, _ in picks], [d for _, d in picks])


# The context lengths of the LLM-decode fleet, each its own task class (its
# own SplitPlan: f_bits curve and full-local seconds).
LLM_CTX_RUNGS = (256, 1024, 4096)


def make_llm_mixed_fleet(arch: str = "qwen3-1.7b", n_cnn: int = 2, ctx_rungs=LLM_CTX_RUNGS, *,
                         gen_tokens: int = 16, kv_bits: int = 8) -> FleetPlan:
    """``n_cnn`` ResNet18 UEs (Jetson and IoT SoC alternating, the device
    mix of ``make_mixed_fleet``) and one LLM-decode UE (``arch``) a context
    rung on a phone NPU (``core.split.llm_decode_split_table``): CNN
    payloads shrink with depth, KV-cache payloads grow with context, and
    both compete for the same channels and servers."""
    from repro_torch.configs import get_config
    cnn = make_resnet18(101)
    cnn_devs = (oh.JETSON_NANO, oh.IOT_SOC)
    picks = [(cnn_split_table(cnn, 224, dev=cnn_devs[i % 2]), cnn_devs[i % 2])
             for i in range(n_cnn)]
    cfg = get_config(arch)
    for ctx in ctx_rungs:
        picks.append((llm_decode_split_table(cfg, ctx, gen_tokens=gen_tokens, ue_dev=oh.PHONE_NPU,
                                             kv_bits=kv_bits), oh.PHONE_NPU))
    return build_fleet([p for p, _ in picks], [d for _, d in picks])


P_COMPUTE_NORM = 5.0        # W
OMEGA_NORM = 1e6            # Hz; the paper's per-channel bandwidth
BITS_NORM = 1e6             # bits
DIST_NORM = 100.0           # m
EDGE_SLOW_NORM = 1e-12      # s/FLOP
RATE_NORM = 1e7             # b/s


def ue_table_features(l_new, n_new, feasible, p_compute, t0):
    """(N, 5) float32 static per-UE descriptors: normalized compute power,
    full-local seconds, feasible-action fraction, and mean feasible local
    seconds / offload bits."""
    l = np.asarray(l_new, np.float64)
    n = np.asarray(n_new, np.float64)
    feas = np.asarray(feasible, bool)
    t0 = float(t0)
    cnt = np.maximum(feas.sum(axis=1), 1)
    return np.stack([
        np.asarray(p_compute, np.float64) / P_COMPUTE_NORM,
        l[:, -1] / t0,
        feas.mean(axis=1),
        (l * feas).sum(axis=1) / cnt / t0,
        (n * feas).sum(axis=1) / cnt / BITS_NORM,
    ], axis=1).astype(np.float32)


def pool_aggregate_features(server_dist, omega, t_edge, feasible, t0):
    """(4,) float32 pool descriptor: nearest / mean server distance scale,
    mean channel bandwidth, and mean edge seconds over feasible offload
    slots (full-local excluded)."""
    om = np.asarray(omega, np.float64)
    dist = np.ones((1,)) if server_dist is None \
        else np.asarray(server_dist, np.float64)
    te_mean = 0.0
    if t_edge is not None:
        feas = np.asarray(feasible, bool)[:, :-1]
        te = np.asarray(t_edge, np.float64)[:, :-1]
        te_mean = float(te[feas].mean() / float(t0))
    return np.array([dist.min(), dist.mean(), om.mean() / OMEGA_NORM,
                     te_mean], np.float32)


def server_slowness(edge_speed) -> float:
    """s/FLOP a server gives an offloaded task (0 = instant edge)."""
    return 1.0 / edge_speed if edge_speed > 0 else 0.0


def pool_geometry(pool) -> np.ndarray:
    """(E, 3) float32 [dist_scale, bw_scale, slowness] rows; ``None`` or
    one paper-default server gives [[1, 1, 0]]."""
    if pool is None or pool.is_single_paper_server:
        return np.array([[1.0, 1.0, 0.0]], np.float32)
    return np.array([[s.dist_scale, s.bw_scale,
                      server_slowness(s.edge_speed)]
                     for s in pool.servers], np.float32)


def random_pool_ranges(n_servers: int, *, dist=(0.9, 2.0), bw=(0.5, 1.25),
                       slow=(0.0, 4.2e-12)):
    """(low, high) (E, 3) geometry bounds for randomized-pool training."""
    low = np.tile(np.array([[dist[0], bw[0], slow[0]]], np.float32),
                  (n_servers, 1))
    high = np.tile(np.array([[dist[1], bw[1], slow[1]]], np.float32),
                   (n_servers, 1))
    return low, high


def ue_edge_work(l_new, feasible, peak_flops):
    """(N, B_max+2) float64 FLOPs of the edge-side tail of each (ue,
    split), zero on padded slots and on full-local."""
    t_loc = np.asarray(l_new, np.float64)
    feas = np.asarray(feasible, bool)
    work = np.maximum(t_loc[:, -1:] - t_loc, 0.0) \
        * np.asarray(peak_flops, np.float64)[:, None]
    work[~feas] = 0.0
    work[:, -1] = 0.0
    return work


@dataclasses.dataclass(frozen=True)
class EdgePool:
    """The ordered servers the ``route`` head picks between. One
    paper-default server is the paper's single-server scenario."""
    servers: Tuple[oh.ServerProfile, ...]

    def __post_init__(self):
        if not self.servers:
            raise ValueError("EdgePool needs at least one server")
        names = [s.name for s in self.servers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate server names: {names}")

    @property
    def n_servers(self) -> int:
        return len(self.servers)

    @property
    def is_single_paper_server(self) -> bool:
        return self.n_servers == 1 and self.servers[0].is_paper_default


def single_server() -> EdgePool:
    """The paper's scenario: one server at the cell center, instantaneous
    edge inference."""
    return EdgePool((oh.ServerProfile("tpu-v5e"),))


def make_edge_pool(n: int = 2) -> EdgePool:
    """The demo pool: the cell-center server, then farther / weaker
    simulated tiers."""
    tiers = [oh.ServerProfile("tpu-v5e", oh.TPU_V5E, 1.0, 1.0, 0.0),
             oh.ServerProfile.from_device(oh.EDGE_GPU, dist_scale=1.4),
             oh.ServerProfile.from_device(oh.EDGE_NUC, dist_scale=1.8,
                                          bw_scale=0.8)]
    if not 1 <= n <= len(tiers):
        raise ValueError(f"demo pool supports 1..{len(tiers)} servers")
    return EdgePool(tuple(tiers[:n]))
