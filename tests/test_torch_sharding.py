"""Sharded rollouts and sharded evaluation of the port (the counterpart of
``tests/test_sharding.py``, whose live tests need two JAX devices), over
two gloo ranks on the CPU.

The config validation and the launch errors run in the test process. The
ranks are spawned once (``launch.mesh.spawn``): each trains one MAHPPO
iteration with the entity agent, with and without ``fused_scorer``, on its
half of 4 envs, and runs ``evaluate_policy(n_envs=4, n_shards=2,
deterministic=False)``. Every draw is made for all the envs and a rank
keeps its own (``actionspace.Rows``), and the critic runs over every
rank's rows, so the sharded run computes what the one-process run does:
the agents equal on both ranks; the first rollout, gathered over the
ranks, equal to one process's (actions exactly); one process's update of
that rollout equal to the sharded iteration to the bit; the evaluation's
summary and per-env rows equal to the unsharded ones. The policy's
products run over a rank's rows, fewer than one process's, and a CPU
BLAS may take another route for another row count (this host's gives the
same bits at these sizes): float leaves are held within 1e-6 of their
largest, where a last-bit difference, amplified by AdamW's first steps on
a gradient that is zero by construction (the route scorer's last bias),
would fail a bitwise check of the whole iteration.
``fleet_demo.main(["--n-shards", "2", ...])`` runs its own ranks.
"""
import time

import numpy as np
import pytest
import torch
from torch.multiprocessing import ProcessRaisedException

from repro_torch import optim
from repro_torch.core.fleets import make_edge_pool, make_mixed_fleet
from repro_torch.launch import fleet_demo
from repro_torch.launch.mesh import rank_devices, spawn
from repro_torch.rl import mahppo
from repro_torch.rl.actionspace import Rows

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

N_ENVS, SHARDS, FRAMES = 4, 2, 8
FUSED = (False, True)


def pool_env():
    return fleet_demo.fleet_env(make_mixed_fleet("qwen3-1.7b", n_ue=4), make_edge_pool(2),
                                randomize=True, device="cpu")


def train_cfg(n_shards, fused):
    return mahppo.MAHPPOConfig(iterations=1, horizon=32, n_envs=N_ENVS, reuse=1, batch=16,
                               entity_policy=True, randomize_pool=True, fused_scorer=fused,
                               n_shards=n_shards)


def params_of(agent):
    return [p.detach().clone() for p in mahppo.agent_parameters(agent)]


def tree_map(fn, tree):
    return {k: tree_map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def leaves(tree):
    return [tree] if not isinstance(tree, dict) else [x for k in sorted(tree)
                                                      for x in leaves(tree[k])]


def first_rollout(env, cfg):
    """The first rollout ``train_mahppo(env, cfg, seed=0)`` collects, as it
    draws it (gathered over the ranks where ``cfg`` shards the envs), with
    the agent, optimizer state and generator it leaves."""
    agent = mahppo.init_agent(torch.Generator().manual_seed(0), env, entity_policy=True)
    opt = optim.adamw_init(mahppo.agent_parameters(agent))
    states = mahppo.init_states(env, cfg, torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    _, traj, last_v = mahppo.make_train_fns(env, cfg).collect(agent, gen, states)
    if cfg.n_shards > 1:
        traj = tree_map(lambda x: mahppo.gather_envs(x, 1), traj)
        last_v = mahppo.gather_envs(last_v, 0)
    return agent, opt, gen, traj, last_v


def within(got, want, tol=1e-6):
    return float((got - want).abs().max()) <= tol * max(float(want.abs().max()), 1e-30)


def evaluate(env, agent, n_shards):
    trace = []
    res = mahppo.evaluate_policy(env, agent, frames=FRAMES, n_envs=N_ENVS, n_shards=n_shards,
                                 deterministic=False, trace=trace)
    rows = torch.stack([torch.stack([t[k] for k in ("reward", "t_sum", "completed")])
                        for t in trace])                  # (frames, 3, the rank's envs)
    return res, rows


def _rank(rank, device):
    env = pool_env()
    out = {}
    for fused in FUSED:
        agent, hist = mahppo.train_mahppo(env, train_cfg(SHARDS, fused), seed=0)
        out[fused] = params_of(agent), hist, first_rollout(env, train_cfg(SHARDS, fused))[3:]
    out["eval"] = evaluate(env, agent, SHARDS)
    return out


def _failing_rank(rank, device):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    time.sleep(60)          # stopped by the launcher when rank 1 fails


@pytest.fixture(scope="module")
def ranks():
    return spawn(_rank, SHARDS, "gloo", device="cpu")


@pytest.fixture(scope="module")
def one_process(ranks):
    """One process: each iteration's own rollout, its update fed the
    sharded run's gathered rollout, its whole iteration's history, and the
    unsharded evaluation of the agent the ranks trained."""
    env = pool_env()
    out = {}
    for fused in FUSED:
        cfg = train_cfg(1, fused)
        agent, opt, gen, traj, last_v = first_rollout(env, cfg)
        sharded_traj, sharded_v = ranks[0][fused][2]
        mahppo.make_train_fns(env, cfg).update(agent, opt, gen, sharded_traj, sharded_v)
        _, hist = mahppo.train_mahppo(env, cfg, seed=0)
        out[fused] = params_of(agent), hist, (traj, last_v)
    trained = mahppo.init_agent(torch.Generator().manual_seed(0), env, entity_policy=True)
    with torch.no_grad():
        for p, v in zip(mahppo.agent_parameters(trained), ranks[0][True][0]):
            p.copy_(v)
    out["eval"] = evaluate(env, trained, 1)
    out["init"] = params_of(mahppo.init_agent(torch.Generator().manual_seed(0), env,
                                              entity_policy=True))
    return out


def test_n_shards_config_validation():
    with pytest.raises(ValueError, match="n_shards"):
        mahppo.MAHPPOConfig(n_shards=0)
    with pytest.raises(ValueError, match="divisible"):
        mahppo.MAHPPOConfig(horizon=64, n_envs=4, n_shards=3)
    assert mahppo.MAHPPOConfig(horizon=64, n_envs=4, n_shards=2).n_shards == 2


def test_sharding_without_ranks_says_how_to_launch():
    env = pool_env()
    agent = mahppo.init_agent(torch.Generator().manual_seed(0), env, entity_policy=True)
    for call in (lambda: mahppo.make_train_fns(env, train_cfg(SHARDS, True)),
                 lambda: mahppo.train_mahppo(env, train_cfg(SHARDS, True)),
                 lambda: mahppo.evaluate_policy(env, agent, frames=2, n_envs=4, n_shards=2)):
        with pytest.raises(ValueError, match="launch 2 ranks with repro_torch.launch.mesh.spawn"):
            call()


def test_eval_shard_count_must_divide_envs():
    env = pool_env()
    agent = mahppo.init_agent(torch.Generator().manual_seed(0), env, entity_policy=True)
    with pytest.raises(ValueError, match="divisible"):
        mahppo.evaluate_policy(env, agent, frames=2, n_envs=3, n_shards=2)


def test_nccl_needs_a_card_a_rank():
    with pytest.raises(ValueError, match="--backend gloo"):
        rank_devices(2, "nccl")
    with pytest.raises(ValueError, match="gloo"):
        rank_devices(2, "nccl", "cpu")
    with pytest.raises(ValueError, match="backend"):
        rank_devices(2, "mpi", "cpu")
    assert rank_devices(3, "gloo", "cpu") == [torch.device("cpu")] * 3


def test_a_failing_rank_fails_the_launch():
    t0 = time.perf_counter()
    with pytest.raises(ProcessRaisedException, match="rank 1 fails on purpose"):
        spawn(_failing_rank, 2, "gloo", device="cpu", timeout_s=60)
    assert time.perf_counter() - t0 < 50      # the waiting rank was stopped


def test_row_blocks_draw_what_one_process_draws():
    env = pool_env()
    full = env.reset(torch.Generator().manual_seed(3), n_envs=4, randomize=True)
    half = env.reset(torch.Generator().manual_seed(3), n_envs=2, randomize=True, rows=Rows(1, 2))
    for f in ("k", "d", "geom"):
        assert torch.equal(getattr(half, f), getattr(full, f)[2:4])
    acts = {"split": torch.zeros((4, 4), dtype=torch.long),
            "channel": torch.zeros((4, 4), dtype=torch.long),
            "route": torch.zeros((4, 4), dtype=torch.long), "power": torch.full((4, 4), 0.1)}
    for _ in range(30):                     # through auto-resets and geometry redraws
        full, *_ = env.step(full, acts)
        half, *_ = env.step(half, {k: v[2:4] for k, v in acts.items()})
    for f in ("k", "l", "n", "d", "geom"):
        assert torch.equal(getattr(half, f), getattr(full, f)[2:4])
    space = env.action_space
    dist = {"split": torch.randn(4, 4, env.n_actions_b), "channel": torch.randn(4, 4, 2),
            "route": torch.randn(4, 4, 2),
            "power": {"mu": torch.randn(4, 4), "log_std": torch.zeros(4, 4)}}
    a_full = space.sample(torch.Generator().manual_seed(5), dist)
    a_half = space.sample(torch.Generator().manual_seed(5),
                          {k: ({j: w[:2] for j, w in v.items()} if isinstance(v, dict)
                               else v[:2]) for k, v in dist.items()}, rows=Rows(0, 2))
    for k in a_full:
        assert torch.equal(a_half[k], a_full[k][:2])


@pytest.mark.parametrize("fused", FUSED)
def test_sharded_iteration_leaves_one_agent_on_every_rank(ranks, fused):
    for a, b in zip(ranks[0][fused][0], ranks[1][fused][0]):
        assert torch.equal(a, b)
    assert ranks[0][fused][1] == ranks[1][fused][1]


@pytest.mark.parametrize("fused", FUSED)
def test_sharded_iteration_equals_one_process(ranks, one_process, fused):
    got, want = ranks[0][fused][2], one_process[fused][2]
    for a, b in zip(leaves(got[0]) + [got[1]], leaves(want[0]) + [want[1]]):
        assert torch.equal(a, b) if not a.is_floating_point() else within(a, b)
    # one process's update of the gathered rollout is the sharded iteration
    for a, b in zip(ranks[0][fused][0], one_process[fused][0]):
        assert torch.equal(a, b)
    for k, v in one_process[fused][1][0].items():
        assert abs(ranks[0][fused][1][0][k] - v) <= 1e-5 * max(abs(v), 1e-30), k


@pytest.mark.parametrize("fused", FUSED)
def test_sharded_iteration_moves_the_agent(ranks, one_process, fused):
    moved = max(float((a - b).abs().max()) for a, b in zip(ranks[0][fused][0],
                                                           one_process["init"]))
    assert moved > 0.0
    assert np.isfinite(ranks[0][fused][1][0]["reward_mean"])


def test_sharded_eval_equals_unsharded(ranks, one_process):
    want, want_rows = one_process["eval"]
    for r in ranks:
        for k, v in want.items():
            assert abs(r["eval"][0][k] - v) <= 1e-6 * max(abs(v), 1e-30), k
    got_rows = torch.cat([r["eval"][1] for r in ranks], dim=-1)
    for i in range(want_rows.shape[1]):            # each field, every frame and env
        assert within(got_rows[:, i], want_rows[:, i])
    # sampled actions and auto-resets part the envs: the rows are no copies
    assert not torch.equal(want_rows[..., 0], want_rows[..., 2])


def test_fleet_demo_n_shards_runs_and_nccl_on_the_cpu_raises(capfd):
    out = fleet_demo.main(["--n-shards", "2", "--device", "cpu", "--backend", "gloo",
                           "--iterations", "1"])
    assert len(out["history"]) == 1 and np.isfinite(out["history"][0]["reward_mean"])
    printed = capfd.readouterr().out          # the ranks write to this process's stdout
    assert printed.count("rollouts sharded over 2 ranks (gloo, cpu)") == 1   # rank 0 only
    with pytest.raises(ValueError, match="gloo"):
        fleet_demo.main(["--n-shards", "2", "--device", "cpu", "--backend", "nccl"])
