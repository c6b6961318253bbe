"""Parity of the port's streaming runtime (``repro_torch.stream``) with the
JAX reference's.

Both packages draw the arrival processes from the same per-UE numpy
streams, so the same scenario and seed give the same tasks, and a
dispatcher that decides what the reference's decides gives the same
records: ``tid``, ``ue``, ``cls``, ``b``, ``channel``, ``server``,
``dropped`` and ``start_seq`` equal, and times, rates and energies within
1e-6 relative (the reference's own closed-form tolerance; the uplink
rates are float32 on both sides, where torch's and XLA's ``log2`` may
differ in the last bit). The fleet is the mixed one of the demos on the
2-server pool (N = 6) and on one server (N = 4). The policy dispatchers
carry the reference's weights, with their last layers scaled so that no
two choices tie within float32 noise.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import fleets as jfleets
from repro.env import mecenv as jenv
from repro.rl import distill as jdistill
from repro.rl import mahppo as jmahppo
from repro.rl import nets as jnets
from repro.stream import adapter as jadapter
from repro.stream import events as jevents
from repro.stream import qos as jqos
from repro_torch import weights
from repro_torch.core import fleets
from repro_torch.env import mecenv
from repro_torch.stream import adapter, dispatcher, events, qos

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

EXACT = ("tid", "ue", "cls", "b", "channel", "server", "dropped", "start_seq")
CLOSE = ("t_arrive", "deadline", "t_start", "t_done", "rate", "t_service", "energy", "power")
RTOL = 1e-6
SCALE = 300.0
BASELINES = ("LocalDispatcher", "GreedyDispatcher", "NearestServerDispatcher",
             "StreamOracleDispatcher")


@functools.lru_cache(maxsize=None)
def _envs(n_servers):
    """(reference env, port env): the mixed fleet, N = 6 on the 2-server
    pool or N = 4 on one server."""
    n = 6 if n_servers > 1 else 4
    jpool = jfleets.make_edge_pool(n_servers) if n_servers > 1 else None
    pool = fleets.make_edge_pool(n_servers) if n_servers > 1 else None
    return (jenv.MECEnv(jenv.make_env_params(jfleets.make_mixed_fleet(n_ue=n), n_channels=2,
                                             pool=jpool)),
            mecenv.MECEnv(mecenv.make_env_params(fleets.make_mixed_fleet(n_ue=n), n_channels=2,
                                                 pool=pool, device="cpu")))


def _params(**kw):
    return jevents.StreamParams(**kw), events.StreamParams(**kw)


def _assert_records(got, want):
    """Record for record, by task id."""
    got = sorted(got, key=lambda r: r.tid)
    want = sorted(want, key=lambda r: r.tid)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in EXACT:
            assert getattr(g, f) == getattr(w, f), (f, g, w)
        for f in CLOSE:
            np.testing.assert_allclose(getattr(g, f), getattr(w, f), rtol=RTOL, atol=0,
                                       err_msg=f"{f} of task {w.tid}")


def _run_checked(sim):
    """Step ``sim`` to its end, the ledger balanced after every event."""
    while True:
        led = sim.ledger()
        assert led["arrivals"] == led["completed"] + led["dropped"] + led["queued"] \
            + led["in_flight"], led
        if not sim.step():
            break
    led = sim.ledger()
    assert led["queued"] == led["in_flight"] == 0
    return sim.report()


def _assert_report(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=0, err_msg=k)


# ------------------------------------------------------------------- qos
def test_qos_metrics_are_exact():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 100):
        x = rng.exponential(size=n)
        got, want = qos.tail_stats(x), jqos.tail_stats(x)
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(list(got.values()), list(want.values()))
    recs = []
    for i in range(40):
        kw = dict(tid=i, ue=i % 5, cls=i % 2, t_arrive=float(rng.random()),
                  deadline=float(rng.random() + 0.5))
        r, jr = qos.TaskRecord(**kw), jqos.TaskRecord(**kw)
        for rec in (r, jr):
            rec.dropped = bool(i % 7 == 0)
            rec.t_start = kw["t_arrive"] + 0.01 * i
            rec.t_done = rec.t_start + float(i % 9) * 0.1
            rec.energy, rec.t_service = 0.001 * i, 0.02 * i
        recs.append((r, jr))
        assert r.sojourn == jr.sojourn and r.missed == jr.missed
        assert r.task_cost(qos.StreamRewardConfig()) == jr.task_cost(jqos.StreamRewardConfig())
    for n in (0, 1, 40):
        mon, jmon = qos.QoSMonitor(), jqos.QoSMonitor()
        for r, jr in recs[:n]:
            mon.add(r)
            jmon.add(jr)
        for horizon in (None, 3.0):
            got, want = mon.report(horizon), jmon.report(horizon)
            assert got.keys() == want.keys()
            np.testing.assert_array_equal(list(got.values()), list(want.values()))
            cfg = dict(miss_penalty=3.0, tail_weight=0.5, energy_weight=0.2)
            for t0 in (0.5, 2.0):
                assert qos.stream_reward(got, qos.StreamRewardConfig(**cfg), t0=t0) == \
                    jqos.stream_reward(want, jqos.StreamRewardConfig(**cfg), t0=t0)
                assert qos.stream_reward(got, t0=t0) == jqos.stream_reward(want, t0=t0)


# ------------------------------------------------ the baseline dispatchers
@pytest.mark.parametrize("deterministic", [False, True], ids=["poisson", "deterministic"])
@pytest.mark.parametrize("name", BASELINES)
@pytest.mark.parametrize("n_servers", [2, 1])
def test_records_agree_with_reference(n_servers, name, deterministic):
    """StreamSim (the ledger balanced after every event) and the daemon
    give the reference StreamSim's records."""
    jv, v = _envs(n_servers)
    jsp, sp = _params(rate=6.0, horizon=2.0, deterministic=deterministic)
    ref = jevents.StreamSim(jv, getattr(jadapter, name)(jv), jsp, seed=3)
    want = ref.run()
    sim = events.StreamSim(v, getattr(adapter, name)(v), sp, seed=3)
    _assert_report(_run_checked(sim), want)
    _assert_records(sim.monitor.records, ref.monitor.records)
    rep, core = dispatcher.run_daemon(v, getattr(adapter, name)(v), sp, seed=3)
    _assert_report(rep, want)
    _assert_records(core.monitor.records, ref.monitor.records)


def test_daemon_gives_the_heap_sim_records_exactly():
    """The port's two runtimes against each other (the reference's own
    cross-runtime check): identical records, bit for bit."""
    _, v = _envs(2)
    sp = events.StreamParams(rate=4.0, horizon=2.5)
    for mk in (adapter.LocalDispatcher, adapter.GreedyDispatcher):
        sim = events.StreamSim(v, mk(v), sp, seed=3)
        rep = sim.run()
        rep_d, core = dispatcher.run_daemon(v, mk(v), sp, seed=3)
        key = lambda recs: sorted((r.tid, r.ue, r.t_arrive, r.t_start, r.t_done, r.dropped,
                                   r.b, r.server, r.rate, r.energy) for r in recs)
        assert key(sim.monitor.records) == key(core.monitor.records)
        assert rep == rep_d


def test_distance_draws_and_saturation_agree():
    """d_eval=None draws the distances from the reference's stream; tight
    deadlines at heavy load drop tasks the same way."""
    jv, v = _envs(2)
    jsp, sp = _params(rate=20.0, horizon=1.5, classes=((1.0, 0.05),), d_eval=None)
    ref = jevents.StreamSim(jv, jadapter.GreedyDispatcher(jv), jsp, seed=5)
    ref.run()
    sim = events.StreamSim(v, adapter.GreedyDispatcher(v), sp, seed=5)
    rep = _run_checked(sim)
    np.testing.assert_array_equal(sim.d, ref.d)
    assert rep["dropped"] > 0
    _assert_records(sim.monitor.records, ref.monitor.records)


def test_stream_env_state_matches_reference():
    """Leaf by leaf, after every event of a lockstep run."""
    jv, v = _envs(2)
    jsp, sp = _params(rate=10.0, horizon=1.0)
    ref = jevents.StreamSim(jv, jadapter.GreedyDispatcher(jv), jsp, seed=2)
    sim = events.StreamSim(v, adapter.GreedyDispatcher(v), sp, seed=2)
    checked = 0
    while True:
        js, s = jadapter.stream_env_state(ref), adapter.stream_env_state(sim)
        assert s.gen is None and s.geom is None
        for f in ("k", "d", "t", "active"):
            np.testing.assert_array_equal(getattr(s, f).numpy(), np.asarray(getattr(js, f)),
                                          err_msg=f)
            assert getattr(s, f).dtype == getattr(weights.env_state_from_jax(js, "cpu"),
                                                  f).dtype, f
        # a remainder is the task's payload less the work done: its error is
        # relative to the payload, not to what is left of it
        for f, table in (("l", v.params.l_new), ("n", v.params.n_new)):
            np.testing.assert_allclose(getattr(s, f).numpy(), np.asarray(getattr(js, f)),
                                       rtol=RTOL, atol=RTOL * float(table.max()), err_msg=f)
        checked += bool(np.asarray(js.n).any())
        if not ref.step():
            assert not sim.step()
            break
        assert sim.step()
    assert checked > 5


def test_oracle_leaves_the_core_as_it_found_it():
    _, v = _envs(2)
    inner = adapter.StreamOracleDispatcher(v)
    same = []

    def spy(core, ue):
        before = [a.copy() for a in (core.tx, core.chan, core.route, core.power)]
        act = inner(core, ue)
        same.append(all(np.array_equal(b, a) for b, a in
                        zip(before, (core.tx, core.chan, core.route, core.power))))
        return act

    sim = events.StreamSim(v, spy, events.StreamParams(rate=6.0, horizon=1.0), seed=1)
    _run_checked(sim)
    assert same and all(same)
    assert inner.p_grid == jadapter.StreamOracleDispatcher(_envs(2)[0]).p_grid


# ------------------------------------------------ the policy dispatchers
@functools.lru_cache(maxsize=None)
def _entity_agent():
    """A reference entity agent with its heads' and scorer's last layers
    scaled by SCALE, and its port copy."""
    jv, _ = _envs(2)
    agent = jax.jit(lambda k: jmahppo.init_agent(k, jv, entity_policy=True))(
        jax.random.PRNGKey(4))
    actor = agent["entity_actor"]
    for layers in list(actor["heads"].values()) + [actor["scorer"]]:
        layers[-1] = {k: v * SCALE for k, v in layers[-1].items()}
    tree = jax.tree_util.tree_map(np.asarray, agent)
    return agent, weights.agent_from_jax(tree, "cpu")


@functools.lru_cache(maxsize=None)
def _trunks():
    """(reference f32, reference int8, port f32, port int8) flat trunks,
    the last layer scaled by SCALE / 10."""
    jv, _ = _envs(2)
    p = jnets.init_flat_trunk(jax.random.PRNGKey(5), jv.ue_feat_dim, jv.action_space)
    p["layers"][-1] = {k: v * SCALE / 10 for k, v in p["layers"][-1].items()}
    q = jdistill.quantize_flat_trunk(p)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return (p, q, weights.flat_trunk_from_jax(np_tree(p), "cpu"),
            weights.flat_trunk_from_jax(np_tree(q), "cpu"))


@pytest.mark.parametrize("live_channel", [False, True], ids=["mode", "live-channel"])
def test_entity_dispatcher_decides_as_reference(live_channel):
    jv, v = _envs(2)
    jagent, agent = _entity_agent()
    jsp, sp = _params(rate=4.0, horizon=2.0)
    ref = jevents.StreamSim(jv, jadapter.EntityDispatcher(jv, jagent, live_channel=live_channel),
                            jsp, seed=0)
    ref.run()
    disp = adapter.EntityDispatcher(v, agent, live_channel=live_channel)
    disp.record = True
    sim = events.StreamSim(v, disp, sp, seed=0)
    _run_checked(sim)
    _assert_records(sim.monitor.records, ref.monitor.records)
    served = [r for r in sim.monitor.records if not r.dropped]
    assert len(disp.decisions) == len(served) > 0
    assert len({(r.b, r.server, r.channel) for r in served}) > 1
    s, raw, ue = disp.decisions[0]
    assert set(raw) == set(v.action_space.names) and raw["split"].shape == (v.params.n_ue,)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_trunk_dispatcher_decides_as_reference(quantized):
    jv, v = _envs(2)
    jp, jq, p, q = _trunks()
    jsp, sp = _params(rate=4.0, horizon=2.0)
    ref = jevents.StreamSim(jv, jadapter.TrunkDispatcher(jv, jq if quantized else jp,
                                                         deterministic=True), jsp, seed=1)
    ref.run()
    sim = events.StreamSim(v, adapter.TrunkDispatcher(v, q if quantized else p,
                                                      deterministic=True), sp, seed=1)
    _run_checked(sim)
    _assert_records(sim.monitor.records, ref.monitor.records)
    served = [r for r in sim.monitor.records if not r.dropped]
    assert len({r.b for r in served}) > 1


def test_sampled_dispatchers_stay_feasible():
    """The deployment modes (sampled, live channel) draw from the port's
    generator: every action within the masks and the heads' ranges."""
    _, v = _envs(2)
    _, agent = _entity_agent()
    _, _, _, q = _trunks()
    feas = v.params.feasible.numpy()
    lo, hi = v.action_space.head("power").low, v.action_space.head("power").high
    for disp in (adapter.EntityDispatcher(v, agent, deterministic=False, live_channel=True,
                                          seed=3),
                 adapter.TrunkDispatcher(v, q, seed=3)):
        sim = events.StreamSim(v, disp, events.StreamParams(rate=4.0, horizon=1.5), seed=0)
        _run_checked(sim)
        served = [r for r in sim.monitor.records if not r.dropped]
        assert served
        for r in served:
            assert feas[r.ue, r.b] and 0 <= r.server < v.n_servers
            assert 0 <= r.channel < v.n_channels and lo <= r.power <= hi


def test_validation_errors_match_reference():
    jv, v = _envs(2)
    for agent in ({"actor": {}, "critic": {}}, {}):
        with pytest.raises(ValueError) as want:
            jadapter.EntityDispatcher(jv, agent)
        with pytest.raises(ValueError) as got:
            adapter.EntityDispatcher(v, agent)
        assert str(got.value) == str(want.value)
    for trunk in ({"entity_actor": {}, "critic": {}}, {}):
        with pytest.raises(ValueError) as want:
            jadapter.TrunkDispatcher(jv, trunk)
        with pytest.raises(ValueError) as got:
            adapter.TrunkDispatcher(v, trunk)
        assert str(got.value) == str(want.value)
