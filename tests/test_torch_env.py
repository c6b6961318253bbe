"""Parity of the port's split tables, fleet, edge pool and MEC env with the
JAX reference, from identical numpy-made states and actions.

The fleet is the scheduling slice's mixed one at N = 16: even UEs run
qwen3-1.7b's split table on a phone NPU, odd UEs mamba2-1.3b's on a
Jetson, against one paper-default server or the 3-server demo pool. The
tables are numpy on both sides, so they must be equal; the env's physics
are float32 on both sides, so they must agree to 1e-5 relative (the two
libraries' pow, log2 and sums round differently in the last bits) with
equal completion counts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import fleets as jfleets
from repro.core import overhead as joh
from repro.core import split as jsplit
from repro.env import mecenv as jenv
from repro_torch.configs import get_config
from repro_torch.core import fleets, split
from repro_torch.core import overhead as oh
from repro_torch.env import mecenv
from repro_torch.launch.dispatch_serve import dispatch_env

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

N = 16
KINDS = [("qwen3-1.7b", "PHONE_NPU"), ("mamba2-1.3b", "JETSON_NANO")]
TOL = dict(rtol=1e-5, atol=1e-6)


def _fleets(n=N):
    jt = [(jsplit.transformer_split_table(jget_config(a), ue_dev=getattr(joh, d)),
           getattr(joh, d)) for a, d in KINDS]
    tt = [(split.transformer_split_table(get_config(a), ue_dev=getattr(oh, d)),
           getattr(oh, d)) for a, d in KINDS]
    pick = lambda t: [t[i % 2] for i in range(n)]
    return (jsplit.build_fleet(*map(list, zip(*pick(jt)))),
            split.build_fleet(*map(list, zip(*pick(tt)))))


def _envs(n_servers):
    jfleet, fleet = _fleets()
    jpool = None if n_servers == 1 else jfleets.make_edge_pool(n_servers)
    pool = None if n_servers == 1 else fleets.make_edge_pool(n_servers)
    return (jenv.MECEnv(jenv.make_env_params(jfleet, n_channels=2, pool=jpool)),
            mecenv.MECEnv(mecenv.make_env_params(fleet, n_channels=2, pool=pool,
                                                 device="cpu")))


_TABLES = ("t_local", "e_local", "t_comp", "e_comp", "f_bits", "feasible")


def test_split_tables_and_fleet_equal_reference():
    for arch, dev in KINDS:
        want = jsplit.transformer_split_table(jget_config(arch), ue_dev=getattr(joh, dev))
        got = split.transformer_split_table(get_config(arch), ue_dev=getattr(oh, dev))
        assert got.points == want.points and got.device == want.device
        assert got.n_actions == want.n_actions == 6 and got.feasible.all()
        for f in _TABLES:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    jfleet, fleet = _fleets()
    assert fleet.names == jfleet.names and fleet.n_actions == jfleet.n_actions
    assert [p.name for p in fleet.profiles] == [p.name for p in jfleet.profiles]
    for f in _TABLES + ("p_compute",):
        np.testing.assert_array_equal(getattr(fleet, f), getattr(jfleet, f))


def test_edge_pool_equals_reference():
    for n in (1, 2, 3):
        jp, p = jfleets.make_edge_pool(n), fleets.make_edge_pool(n)
        assert [s.name for s in p.servers] == [s.name for s in jp.servers]
        for a, b in zip(p.servers, jp.servers):
            assert (a.dist_scale, a.bw_scale, a.edge_speed) == \
                (b.dist_scale, b.bw_scale, b.edge_speed)
        np.testing.assert_array_equal(fleets.pool_geometry(p), jfleets.pool_geometry(jp))
    assert fleets.single_server().is_single_paper_server


@pytest.mark.parametrize("n_servers", [1, 3])
def test_env_params_equal_reference(n_servers):
    jv, v = _envs(n_servers)
    jp, p = jv.params, v.params
    for f in ("l_new", "n_new", "feasible", "p_compute", "omega", "sigma", "server_dist",
              "t_edge", "pool_geom", "omega_cell", "edge_work"):
        a, b = getattr(p, f), getattr(jp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
            assert a.dtype == (torch.bool if f == "feasible" else torch.float32), f
    for f in ("t0", "beta", "p_max", "lam_tasks", "d_low", "d_high", "pathloss"):
        assert getattr(p, f) == float(getattr(jp, f)), f
    assert p.n_ue == jp.n_ue == N
    np.testing.assert_array_equal(v._ue_static.numpy(), np.asarray(jv._ue_static))
    np.testing.assert_array_equal(v._pool_static.numpy(), np.asarray(jv._pool_static))
    np.testing.assert_array_equal(v._ue_work_mean.numpy(), np.asarray(jv._ue_work_mean))
    # sigma's mean sums E * C float32 values in another order: one ULP
    np.testing.assert_allclose(v._scorer_consts.numpy(), np.asarray(jv._scorer_consts),
                               rtol=2.4e-7)
    assert v.action_space.names == jv.action_space.names
    assert v.ue_feat_dim == jv.ue_feat_dim == 19 and v.entity_dims == jv.entity_dims


def _states(seed, env_n=N, t0=0.5):
    """Identical states for both envs: varied queues and distances, open
    carry-overs (l beyond one frame, bits beyond one frame's rate),
    sub-bit remainders, finished queues."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 6, env_n).astype(np.float32)
    k[0] = 0.0
    l = np.where(rng.random(env_n) < 0.4, rng.uniform(0, 3 * t0, env_n), 0.0).astype(np.float32)
    n = np.where(rng.random(env_n) < 0.5, rng.uniform(1e4, 3e7, env_n), 0.0).astype(np.float32)
    n[1], l[1] = 0.4, 0.0            # a sub-bit remainder
    n[2], l[2] = 0.0, 1.7 * t0       # local work beyond the frame
    n[3], l[3] = 5e7, 0.0            # bits beyond the frame
    n[4], l[4] = 1.5, np.float32(t0) - np.float32(2e-6)   # the frame may end < 1 bit short
    k[1:5] = (2.0, 3.0, 1.0, 1.0)
    # Not nearer than 5 m: there one UE's received power outweighs the rest
    # of its slot by 1e4 or more, the float32 interference sum (slot total
    # minus own power) cancels, and two sum orders move that UE's rate by
    # more than 1e-5 (2e-5 at 2.3 m). Eval mode puts every UE at 50 m.
    d = rng.uniform(5.0, 100.0, env_n).astype(np.float32)
    return k, l, n, d


def _jstate(arrs):
    k, l, n, d = map(jnp.asarray, arrs)
    return jenv.EnvState(k=k, l=l, n=n, d=d, t=jnp.int32(3), key=jnp.zeros((2,), jnp.uint32),
                         active=jnp.ones((N,), bool))


def _tstate(arrs):
    k, l, n, d = map(torch.from_numpy, arrs)
    return mecenv.EnvState(k=k, l=l, n=n, d=d, t=torch.tensor(3, dtype=torch.int32),
                           gen=torch.Generator().manual_seed(0),
                           active=torch.ones((N,), dtype=torch.bool))


def _actions(seed, env, n_servers):
    rng = np.random.default_rng(100 + seed)
    feas = env.params.feasible.numpy()
    split_ = np.array([rng.choice(np.flatnonzero(row)) for row in feas], np.int32)
    a = {"split": split_, "channel": rng.integers(0, 2, N).astype(np.int32),
         "power": rng.uniform(0.0, 0.6, N).astype(np.float32)}   # some clip to p_max
    if n_servers > 1:
        a["route"] = rng.integers(0, n_servers, N).astype(np.int32)
    return {k: jnp.asarray(v) for k, v in a.items()}, \
        {k: torch.from_numpy(v) for k, v in a.items()}


@pytest.mark.parametrize("n_servers", [1, 3])
def test_observations_and_masks_agree(n_servers):
    jv, v = _envs(n_servers)
    for seed in range(3):
        arrs = _states(seed)
        js, s = _jstate(arrs), _tstate(arrs)
        np.testing.assert_allclose(v.observe_per_ue(s).numpy(),
                                   np.asarray(jv.observe_per_ue(js)), **TOL)
        want, got = jv.observe_entities(js), v.observe_entities(s)
        for key in ("ue", "server", "edge"):
            assert got[key].shape == want[key].shape
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL)
        want, got = jv.observe_entities_raw(js), v.observe_entities_raw(s)
        np.testing.assert_allclose(got["ue"].numpy(), np.asarray(want["ue"]), **TOL)
        for key in ("d", "work", "active", "geom"):
            np.testing.assert_array_equal(got["raw"][key].numpy(), np.asarray(want["raw"][key]))
        np.testing.assert_allclose(got["raw"]["consts"].numpy(),
                                   np.asarray(want["raw"]["consts"]), rtol=2.4e-7)
    jm, m = jv.action_masks(js), v.action_masks(s)
    assert set(m) == set(jm) == {"split"}
    np.testing.assert_array_equal(m["split"].numpy(), np.asarray(jm["split"]))


@pytest.mark.parametrize("n_servers", [1, 3])
def test_step_and_task_overhead_agree(n_servers):
    jv, v = _envs(n_servers)
    completed = eps_bits = 0.0
    for seed in range(6):
        arrs = _states(seed)
        js, s = _jstate(arrs), _tstate(arrs)
        ja, a = _actions(seed, v, n_servers)
        jn, jr, jdone, jinfo = jv.step(js, ja)
        nxt, r, done, info = v.step(s, a)
        assert bool(done) == bool(jdone)
        for f in ("k", "l", "n", "d"):
            np.testing.assert_allclose(getattr(nxt, f).numpy(), np.asarray(getattr(jn, f)),
                                       err_msg=f, **TOL)
        np.testing.assert_array_equal(nxt.k.numpy(), np.asarray(jn.k))
        assert int(nxt.t) == int(jn.t) == 4
        np.testing.assert_allclose(float(r), float(jr), rtol=1e-5)
        assert float(info["completed"]) == float(jinfo["completed"])
        completed += float(info["completed"])
        # the open carry-overs survive the frame
        assert float(nxt.l[2]) == float(jn.l[2]) > 0 and float(nxt.n[3]) > 0
        eps_bits += float(info["eps_bits"])
        for key in ("energy", "rate_mean", "offloads", "n_active", "spawned", "dropped"):
            np.testing.assert_allclose(float(info[key]), float(jinfo[key]), rtol=1e-5,
                                       err_msg=key)
        # the bits absorbed below TX_EPS_BITS: below one bit per UE
        np.testing.assert_allclose(float(info["eps_bits"]), float(jinfo["eps_bits"]),
                                   atol=1e-3)
        if n_servers > 1:
            np.testing.assert_array_equal(info["server_load"].numpy(),
                                          np.asarray(jinfo["server_load"]))
        jt, je = jv.task_overhead(js, ja)
        t, e = v.task_overhead(s, a)
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-5)
        np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-5)
    assert completed > 0 and eps_bits > 0


def test_reset_and_what_waits():
    _, v = _envs(3)
    s = v.reset(eval_mode=True)
    assert (s.k == 200.0).all() and (s.d == 50.0).all() and (s.l == 0).all()
    s = v.reset(torch.Generator().manual_seed(1))
    assert ((s.d >= 1.0) & (s.d <= 100.0)).all() and s.k.dtype == torch.float32
    # churn is accepted: the env is dynamic and observes 6 features a UE
    dyn = mecenv.MECEnv(mecenv.make_env_params(_fleets()[1], churn_rate=0.1, device="cpu"))
    assert dyn.dynamic and not v.dynamic and dyn.obs_dim == 6 * N
    # resampled geometry needs pool_ranges, as in the reference
    with pytest.raises(ValueError, match="pool_ranges"):
        v.reset(eval_mode=True, randomize=True)


def test_dispatch_env_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """The scheduling entry's env, like every entry point, takes the card by
    default and raises when there is none and no device was given."""
    assert dispatch_env(4, 3, "cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dispatch_env(4, 3)


def test_make_env_params_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """The public env constructor takes the card by default and raises when
    there is none and no device was given, a dynamic fleet's as a static
    one's."""
    fleet = _fleets()[1]
    assert mecenv.make_env_params(fleet, device="cpu").l_new.device == torch.device("cpu")
    assert mecenv.make_env_params(fleet, leave_rate=0.1, device="cpu").leave_rate == \
        pytest.approx(0.1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mecenv.make_env_params(fleet)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mecenv.make_env_params(fleet, leave_rate=0.1)
