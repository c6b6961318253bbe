"""Parity of the port's heuristics and baselines with the JAX reference, and
the fleet demo on the CPU.

Greedy, nearest-server, load-balanced and the exhaustive static oracle run
on the mixed fleet (``make_mixed_fleet``, 4 UEs) with 1 and 2 servers and
on a 3-UE CNN fleet: their decisions (splits, channels, routes) must be
equal, and their per-task latency, energy and overhead within 1e-6
relative (float32 physics on both sides). The reference's oracle scores
one joint action per eager call, so it is run where its joint space is
small: on the mixed fleet with 3 (one server) or 2 (two servers) of the 4
UEs active (the standby ones pinned to full-local, as the function does),
and on the whole CNN fleet. The random policy's draws differ by
construction: they are checked for their ranges, and the reference's own
draws, fed to the port, must give the same per-frame means.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cnn as jcnn
from repro.core import fleets as jfleets
from repro.core import overhead as joh
from repro.core import split as jsplit
from repro.env import mecenv as jenv
from repro.rl import baselines as jbaselines
from repro.rl import heuristics as jheuristics
from repro_torch.core import cnn, fleets, split
from repro_torch.core import overhead as oh
from repro_torch.env import mecenv
from repro_torch.launch import fleet_demo
from repro_torch.rl import baselines, heuristics

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

FLEETS = ["mixed-1", "mixed-2", "cnn-1"]
DECISIONS = ("b", "c", "route")
VALUES = ("t_task", "e_task", "overhead")


def _cnn_fleet(cnn_lib, split_lib, ohm):
    plans = [(split_lib.cnn_split_table(cnn_lib.make_resnet18(101), 224, dev=ohm.JETSON_NANO),
              ohm.JETSON_NANO),
             (split_lib.cnn_split_table(cnn_lib.make_mobilenetv2(101), 224, dev=ohm.IOT_SOC),
              ohm.IOT_SOC),
             (split_lib.cnn_split_table(cnn_lib.make_vgg11(101), 224, dev=ohm.JETSON_NANO),
              ohm.JETSON_NANO)]
    return split_lib.build_fleet([p for p, _ in plans], [d for _, d in plans])


@functools.lru_cache(maxsize=None)
def _envs(which):
    kind, n_srv = which.split("-")
    n_srv = int(n_srv)
    if kind == "mixed":
        jfleet, fleet = (jfleets.make_mixed_fleet("qwen3-1.7b", 4),
                         fleets.make_mixed_fleet("qwen3-1.7b", 4))
    else:
        jfleet, fleet = _cnn_fleet(jcnn, jsplit, joh), _cnn_fleet(cnn, split, oh)
    jpool = jfleets.make_edge_pool(n_srv) if n_srv > 1 else None
    pool = fleets.make_edge_pool(n_srv) if n_srv > 1 else None
    return (jenv.MECEnv(jenv.make_env_params(jfleet, n_channels=2, pool=jpool)),
            mecenv.MECEnv(mecenv.make_env_params(fleet, n_channels=2, pool=pool, device="cpu")))


def _same(got, want):
    assert set(got) == set(want)
    for k in DECISIONS:
        if k in want:
            assert [int(x) for x in got[k]] == [int(x) for x in want[k]], k
    for k in VALUES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("which", FLEETS)
def test_greedy_and_fixed_routes_agree(which):
    jv, v = _envs(which)
    _same(heuristics.greedy_eval(v), jheuristics.greedy_eval(jv))
    active = np.array([True, False, True] + [True] * (v.params.n_ue - 3))
    _same(heuristics.greedy_eval(v, active=active), jheuristics.greedy_eval(jv, active=active))
    if v.multi_server:
        for port, ref in ((baselines.nearest_server_eval, jbaselines.nearest_server_eval),
                          (baselines.load_aware_eval, jbaselines.load_aware_eval)):
            _same(port(v), ref(jv))
            _same(port(v, active=active), ref(jv, active=active))
    else:
        with pytest.raises(ValueError, match="multi-server"):
            baselines.nearest_server_eval(v)


@pytest.mark.parametrize("which,active", [("mixed-1", (1, 1, 1, 0)), ("mixed-2", (1, 0, 1, 0)),
                                          ("cnn-1", (1, 1, 1))])
def test_oracle_agrees(which, active):
    jv, v = _envs(which)
    active = np.array(active, bool)
    want = jheuristics.oracle_static_eval(jv, active=active)
    got = heuristics.oracle_static_eval(v, active=active)
    _same(got, want)
    assert heuristics.oracle_static_eval(v, active=active)["overhead"] <= \
        heuristics.greedy_eval(v, active=active)["overhead"]
    with pytest.raises(ValueError, match="too large"):
        heuristics.oracle_static_eval(v, active=active, max_joint=10)


def _reference_draws(jv, frames, seed=0):
    """The reference's random-policy actions, drawn as its rollout draws
    them (the fleet is static, so its mask does not depend on the state)."""
    n = jv.params.n_ue
    logits = jnp.where(jv.action_masks()["split"], 0.0, -jnp.inf)
    out = []
    for sub in jax.random.split(jax.random.PRNGKey(seed), frames):
        keys = jax.random.split(sub, 4 if jv.multi_server else 3)
        a = {"split": jax.vmap(jax.random.categorical)(jax.random.split(keys[0], n),
                                                        logits).astype(jnp.int32),
             "channel": jax.random.randint(keys[1], (n,), 0, jv.n_channels),
             "power": jax.random.uniform(keys[2], (n,), minval=0.01, maxval=jv.params.p_max)}
        if jv.multi_server:
            a["route"] = jax.random.randint(keys[3], (n,), 0, jv.n_servers)
        out.append({k: torch.from_numpy(np.asarray(x)) for k, x in a.items()})
    return out


@pytest.mark.parametrize("which", ["mixed-1", "mixed-2"])
def test_random_policy_draws_and_means(which):
    jv, v = _envs(which)
    trace = []
    res = baselines.random_policy_eval(v, frames=16, trace=trace)
    assert set(res) == {"reward", "completed"} and np.isfinite(res["reward"])
    feas = v.params.feasible
    for a in trace:
        assert bool(feas.gather(1, a["split"].long()[:, None]).all())
        assert bool(((a["channel"] >= 0) & (a["channel"] < v.n_channels)).all())
        assert bool(((a["power"] >= 0.01) & (a["power"] <= v.params.p_max)).all())
        if v.multi_server:
            assert bool(((a["route"] >= 0) & (a["route"] < v.n_servers)).all())
    want = jbaselines.random_policy_eval(jv, frames=16)
    got = baselines.random_policy_eval(v, frames=16, actions=_reference_draws(jv, 16))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_fleet_demo_runs_on_the_cpu(capsys):
    out = fleet_demo.main(["--device", "cpu", "--fused-scorer", "--servers", "2",
                           "--iterations", "1"])
    text = capsys.readouterr().out
    assert "zero-shot on an UNSEEN 3-server pool" in text.strip().splitlines()[-1]
    for line in ("MAHPPO :", "greedy :", "nearest:", "loadbal:", "actor parameters:",
                 "learned route distribution"):
        assert line in text, line
    assert len(out["history"]) == 1 and np.isfinite(out["history"][0]["reward_mean"])
    assert out["env"].randomizable and np.isfinite(out["zero_shot"]["overhead"])
    # --llm and --distill run, here together: the LLM fleet's pool is static,
    # so the student is distilled on the env the teacher trained on
    both = fleet_demo.main(["--device", "cpu", "--iterations", "1", "--llm", "--distill"])
    assert isinstance(both["llm_shift"], bool) and both["env"].params.t0 == 2.0
    assert [h["states"] for h in both["distill"]["history"]] == [192, 384]
    # churn is accepted; the reference refuses it beside --distill
    with pytest.raises(SystemExit):
        fleet_demo.main(["--device", "cpu", "--churn", "--distill"])
    # --n-shards runs its ranks (tests/test_torch_sharding.py); nccl needs a card a rank
    with pytest.raises(ValueError, match="gloo"):
        fleet_demo.main(["--device", "cpu", "--n-shards", "2", "--backend", "nccl"])
