"""Dynamic fleets (UE churn) in the port: parity with the JAX reference and
the reference's churn invariants.

Parity runs on ``test_torch_env``'s mixed fleet (N = 16) made dynamic
(join intensity 0.3, leave probability 0.2), against one paper-default
server or the 3-server pool. The reference draws a frame's churn variates
from its threefry key; the tests compute the same draws from the same key
and inject them into the port's ``MECEnv._draw_churn``, so a frame's
joins, leaves, fresh queues and distances are the reference's. The
physics are float32 on both sides and held to ``test_torch_env``'s
``TOL``; masks, membership and completions must be equal.

The invariants are those of ``tests/test_churn_properties.py``, on its
4-UE ResNet18 fleet, a few seeds each: the task ledger balances every
frame, standby UEs are inert, membership changes only as churn allows, and
zero churn is the static env draw for draw.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fleets as jfleets
from repro.env import mecenv as jenv
from repro.rl import mahppo as jmahppo
from repro_torch import weights
from repro_torch.core import cnn, fleets, split
from repro_torch.env import mecenv
from repro_torch.launch import fleet_demo
from repro_torch.rl import mahppo

from test_torch_env import N, TOL, _actions, _fleets, _states
from test_torch_policy import SCALE, _entity, _margin

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

CHURN, LEAVE = 0.3, 0.2


@functools.lru_cache(maxsize=None)
def _dyn_envs(n_servers):
    jfleet, fleet = _fleets()
    jpool = None if n_servers == 1 else jfleets.make_edge_pool(n_servers)
    pool = None if n_servers == 1 else fleets.make_edge_pool(n_servers)
    jv = jenv.MECEnv(jenv.make_env_params(jfleet, n_channels=2, pool=jpool, churn_rate=CHURN,
                                          leave_rate=LEAVE))
    v = mecenv.MECEnv(mecenv.make_env_params(fleet, n_channels=2, pool=pool, churn_rate=CHURN,
                                             leave_rate=LEAVE, device="cpu"))
    return jv, v, jax.jit(jv.step)


def _reference_churn(key, prm, n):
    """The churn variates the reference's step draws from a state's key."""
    _, _, kj, kl, kf, kd = jax.random.split(key, 6)
    return (jax.random.uniform(kj, (n,)), jax.random.uniform(kl, (n,)),
            jax.random.poisson(kf, prm.lam_tasks, (n,)).astype(jnp.float32),
            jax.random.uniform(kd, (n,), minval=prm.d_low, maxval=prm.d_high))


def _inject(monkeypatch, v, draws):
    """Have the port's env take ``draws`` (a list of reference variates, one
    tuple a frame) in order."""
    it = iter(draws)
    monkeypatch.setattr(v, "_draw_churn", lambda gen, shape: tuple(
        torch.from_numpy(np.array(x)).reshape(shape) for x in next(it)))


def _dyn_states(seed):
    """A state of the dynamic fleet: ``_states``' queues and carry-overs on
    the active UEs, standby UEs empty (as churn leaves them)."""
    k, l, n, d = _states(seed)
    active = np.random.default_rng(50 + seed).random(N) < 0.6
    active[1:5] = True                   # the carry-over cases stay in
    for a in (k, l, n):
        a[~active] = 0.0
    key = jax.random.PRNGKey(seed)
    js = jenv.EnvState(k=jnp.asarray(k), l=jnp.asarray(l), n=jnp.asarray(n), d=jnp.asarray(d),
                       t=jnp.int32(3), key=key, active=jnp.asarray(active))
    s = mecenv.EnvState(k=torch.from_numpy(k), l=torch.from_numpy(l), n=torch.from_numpy(n),
                        d=torch.from_numpy(d), t=torch.tensor(3, dtype=torch.int32),
                        gen=torch.Generator().manual_seed(0), active=torch.from_numpy(active))
    return js, s


@pytest.mark.parametrize("n_servers", [1, 3])
def test_step_observe_and_masks_agree_with_injected_draws(monkeypatch, n_servers):
    jv, v, jstep = _dyn_envs(n_servers)
    assert v.dynamic and jv.dynamic and v.obs_dim == jv.obs_dim == 6 * N
    joins = leaves = 0
    for seed in range(6):
        js, s = _dyn_states(seed)
        np.testing.assert_allclose(v.observe(s).numpy(), np.asarray(jv.observe(js)), **TOL)
        m, jm = v.action_masks(s), jv.action_masks(js)
        np.testing.assert_array_equal(m["split"].numpy(), np.asarray(jm["split"]))
        assert not m["split"][~s.active, :-1].any() and m["split"][:, -1].all()
        ja, a = _actions(seed, v, n_servers)
        _inject(monkeypatch, v, [_reference_churn(js.key, jv.params, N)])
        jn, jr, jdone, jinfo = jstep(js, ja)
        nxt, r, done, info = v.step(s, a)
        assert not bool(done) and not bool(jdone)
        np.testing.assert_array_equal(nxt.active.numpy(), np.asarray(jn.active))
        assert int(nxt.t) == int(jn.t) == 4
        for f in ("k", "l", "n", "d"):
            np.testing.assert_allclose(getattr(nxt, f).numpy(), np.asarray(getattr(jn, f)),
                                       err_msg=f, **TOL)
        np.testing.assert_array_equal(nxt.k.numpy(), np.asarray(jn.k))
        np.testing.assert_allclose(float(r), float(jr), rtol=1e-5)
        for key in ("completed", "spawned", "dropped", "n_active", "energy", "offloads"):
            np.testing.assert_allclose(float(info[key]), float(jinfo[key]), rtol=1e-5,
                                       err_msg=key)
        joins += int((nxt.active & ~s.active).sum())
        leaves += int((s.active & ~nxt.active).sum())
    assert joins > 0 and leaves > 0


@functools.lru_cache(maxsize=None)
def _train_setup(mode):
    """The reference's rollout closures and an agent on the dynamic
    3-server fleet, the agent carried into the port."""
    jv, v, _ = _dyn_envs(3)
    flags = {"actors": {}, "entity": dict(entity_policy=True, fused_scorer=True)}[mode]
    jcfg = jmahppo.MAHPPOConfig(horizon=8, n_envs=2, batch=8, **flags)
    cells = _cells(_cells(jmahppo.make_train_fns(jv, jcfg).__wrapped__)["collect"])
    c = _cells(cells["sample_step"])
    agent_flags = {"entity_policy": True} if mode == "entity" else {}
    jagent = jax.jit(lambda k: jmahppo.init_agent(k, jv, **agent_flags))(jax.random.PRNGKey(1))
    agent = weights.agent_from_jax(jax.tree_util.tree_map(np.asarray, jagent), "cpu")
    return jv, v, c, jagent, agent, mahppo.MAHPPOConfig(horizon=8, n_envs=2, batch=8, **flags)


def _cells(fn):
    out = {}
    for name, cell in zip(fn.__code__.co_freevars, fn.__closure__ or ()):
        try:
            out[name] = cell.cell_contents
        except ValueError:
            pass
    return out


def test_sample_step_masks_each_env_from_its_state():
    """The port's rollout step on two envs of different membership, the
    entity agent through the fused scorer (the path the card trains): every
    inactive UE takes full-local, the per-env masks are the reference's, and
    the log-probs of the port's actions under the reference's distribution
    (built from the same observations and per-env masks) match the port's
    (1e-5)."""
    mode = "entity"
    jv, v, c, jagent, agent, cfg = _train_setup(mode)
    pairs = [_dyn_states(seed) for seed in (0, 1)]
    jstates = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[p[0] for p in pairs])
    states = mecenv.EnvState(*[torch.stack([getattr(p[1], f) for p in pairs])
                               for f in ("k", "l", "n", "d", "t")],
                             gen=torch.Generator().manual_seed(0),
                             active=torch.stack([p[1].active for p in pairs]))
    assert not bool((states.active[0] == states.active[1]).all())
    with torch.no_grad():
        _, tr = mahppo.make_train_fns(v, cfg).sample_step(agent, torch.Generator().manual_seed(3),
                                                          states)
    local = v.n_actions_b - 1
    assert bool((tr["actions"]["split"][~states.active] == local).all())
    assert bool((tr["actions"]["split"][states.active] != local).any())
    space = jv.action_space

    @jax.jit
    def reference(states, actions, active):
        obs = c["_observe"](states)
        masks = jax.vmap(jv.action_masks)(states)
        if mode == "entity":
            masks = jax.vmap(lambda m: space.broadcast_masks(m, N))(masks)
            dist, _ = jax.vmap(lambda o, m: c["_policy_value"](jagent, o, m))(obs, masks)
        else:
            dist = jax.vmap(lambda o, m: c["_dist"](jagent, o, m))(obs, masks)
        return masks, jax.vmap(jax.vmap(space.log_prob))(dist, actions, active)

    jact = {k: jnp.asarray(x.numpy()) for k, x in tr["actions"].items()}
    jmasks, jlp = reference(jstates, jact, jnp.asarray(tr["active"].numpy()))
    np.testing.assert_array_equal(v.action_masks(states)["split"].numpy(),
                                  np.asarray(jmasks["split"]))
    np.testing.assert_allclose(tr["logp"].numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
    assert bool((tr["logp"][~states.active] == 0).all())


def test_evaluate_policy_builds_masks_every_frame(monkeypatch):
    """The entity agent through the fused scorer on the dynamic 3-server
    fleet for 16 eval frames, the reference's churn draws injected frame by
    frame: every standby UE takes full-local in every frame, membership
    changes during the run, and the summary (t_task and e_task weighed over
    the active UEs) matches the reference's (1e-5)."""
    jv, v, _ = _dyn_envs(3)
    jagent, tree = _entity(SCALE)
    jagent = {"entity_actor": jagent["entity_actor"]}
    agent = {"entity_actor": weights.entity_actor_from_jax(tree["entity_actor"], "cpu")}
    frames = 16
    key = jax.random.split(jax.random.PRNGKey(0), 3)[2]       # the eval reset's state key
    draws = []
    for _ in range(frames):
        draws.append(_reference_churn(key, jv.params, N))
        key = jax.random.split(key, 6)[0]
    _inject(monkeypatch, v, draws)
    want = jmahppo.evaluate_policy(jv, jagent, frames=frames, fused_scorer=True)
    assert want["done"] == 0.0
    trace = []
    got = mahppo.evaluate_policy(v, agent, frames=frames, fused_scorer=True, trace=trace)
    assert len(trace) == frames and _margin(trace) > 1e-3
    local = v.n_actions_b - 1
    members = {tuple(fr["active"].tolist()) for fr in trace}
    assert len(members) > 1
    for fr in trace:
        assert bool((fr["actions"]["split"][~fr["active"]] == local).all())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert 0 < got["n_active"] < N


# ------------------------------------------------------------- invariants
def _small_env(churn=0.3, leave=0.2, n_ue=4, lam=15.0):
    """``test_churn_properties``' fleet; ``churn=None`` passes no churn
    arguments at all."""
    plan = split.cnn_split_table(cnn.make_resnet18(101), 224)
    rates = {} if churn is None else dict(churn_rate=churn, leave_rate=leave)
    return mecenv.MECEnv(mecenv.make_env_params(plan, n_ue=n_ue, n_channels=2, lam_tasks=lam,
                                                device="cpu", **rates))


def _random_actions(env, rng, b=None):
    n = env.params.n_ue
    return {"split": torch.from_numpy(rng.randint(0, env.n_actions_b, n) if b is None
                                      else np.full(n, b)).to(torch.int32),
            "channel": torch.from_numpy(rng.randint(0, env.n_channels, n)).to(torch.int32),
            "power": torch.from_numpy(rng.uniform(0.05, 0.5, n).astype(np.float32))}


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_task_ledger_balances_every_frame(seed):
    env = _small_env()
    s = env.reset(torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    initial = float(s.k.sum())
    completed = dropped = spawned = 0.0
    done = False
    for _ in range(200):
        k_pre = float(s.k.sum())
        s, _, done, info = env.step(s, _random_actions(env, rng))
        for key in ("energy", "completed", "dropped", "spawned"):
            assert float(info[key]) >= 0.0
        completed += float(info["completed"])
        dropped += float(info["dropped"])
        spawned += float(info["spawned"])
        if bool(done):
            break
        expect = k_pre - float(info["completed"]) - float(info["dropped"]) + float(info["spawned"])
        assert float(s.k.sum()) == pytest.approx(expect, abs=1e-3)
        for f in ("k", "l", "n"):         # standby slots hold no work
            assert bool((getattr(s, f)[~s.active] == 0).all())
    assert bool(done)
    assert completed + dropped == pytest.approx(initial + spawned, abs=2.0)


@pytest.mark.parametrize("seed", [1, 2, 42])
def test_standby_ues_are_inert(seed):
    """A standby UE with a planted queue and half-sent task changes nothing
    against the same state with them zeroed."""
    env = _small_env(churn=0.0, leave=0.1)
    assert env.dynamic
    rng = np.random.RandomState(seed)
    n = env.params.n_ue
    s = env.reset(torch.Generator().manual_seed(seed))
    idx = rng.randint(0, n)
    active = torch.ones(n, dtype=torch.bool)
    active[idx] = False
    loaded, bits = s.k.clone(), torch.zeros(n)
    loaded[idx], bits[idx] = 50.0, 1e5
    zeroed = loaded.clone()
    zeroed[idx] = 0.0
    a = {"split": torch.from_numpy(rng.randint(0, env.n_actions_b - 1, n)).to(torch.int32),
         "channel": torch.zeros(n, dtype=torch.int32), "power": torch.full((n,), 0.5)}
    out = []
    for k, nb in ((loaded, bits), (zeroed, torch.zeros(n))):
        g = torch.Generator().manual_seed(99)       # the same churn draws for both
        out.append(env.step(s._replace(k=k, n=nb, active=active, gen=g), a))
    (sa, ra, da, ia), (sb, rb, db, ib) = out
    assert float(ra) == float(rb)
    for key in ("energy", "completed", "rate_mean", "offloads"):
        assert float(ia[key]) == float(ib[key]), key
    if not bool(db):
        for f in ("k", "l", "n", "d"):
            np.testing.assert_array_equal(getattr(sa, f)[active].numpy(),
                                          getattr(sb, f)[active].numpy())


def test_membership_changes_only_as_churn_allows():
    """Joins come only from standby and leaves only from active; a joiner
    starts with no work in flight and a distance in range; an auto-reset
    makes the whole fleet active."""
    env = _small_env(churn=0.5, leave=0.4, lam=30.0)
    s = env.reset(torch.Generator().manual_seed(11))
    rng = np.random.RandomState(11)
    saw_join = saw_leave = saw_reset = False
    for _ in range(300):
        before = s.active.clone()
        s, _, done, _ = env.step(s, _random_actions(env, rng, b=1))
        if bool(done):
            assert bool(s.active.all())
            saw_reset = True
            continue
        joined, left = s.active & ~before, before & ~s.active
        saw_join |= bool(joined.any())
        saw_leave |= bool(left.any())
        assert bool((s.l[joined] == 0).all() and (s.n[joined] == 0).all())
        assert bool(((s.d >= env.params.d_low) & (s.d <= env.params.d_high)).all())
    assert saw_join and saw_leave and saw_reset


def test_zero_churn_is_the_static_env_draw_for_draw():
    """churn = leave = 0 through the same entry point is the static env: 4N
    observations, no churn info, the same states as an env built without
    the arguments, and a step draws only its auto-reset."""
    zero, static = _small_env(0.0, 0.0, lam=20.0), _small_env(None, lam=20.0)
    assert not zero.dynamic and zero.obs_dim == 4 * zero.params.n_ue
    gens = [torch.Generator().manual_seed(5) for _ in range(3)]
    s, t = zero.reset(gens[0]), static.reset(gens[1])
    rng = np.random.RandomState(5)
    for _ in range(40):
        a = _random_actions(zero, rng)
        s, _, _, info = zero.step(s, a)
        t, _, _, _ = static.step(t, a)
        assert float(info["spawned"]) == float(info["dropped"]) == 0.0
        for f in ("k", "l", "n", "d", "active"):
            assert bool((getattr(s, f) == getattr(t, f)).all()), f
    zero.reset(gens[2])
    for _ in range(40):
        zero._draw_tasks(gens[2], (zero.params.n_ue,))
    assert bool((gens[0].get_state() == gens[2].get_state()).all())


def test_fleet_demo_churns_on_the_cpu(capsys):
    out = fleet_demo.main(["--device", "cpu", "--churn", "--iterations", "1"])
    text = capsys.readouterr().out
    for line in ("dynamic fleet: join intensity 0.2, leave prob 0.1/frame", "frame  0:",
                 "mean fleet size over eval", "MAHPPO :", "greedy :", "nearest:", "loadbal:"):
        assert line in text, line
    assert out["env"].dynamic and out["env"].randomizable
    assert len(out["membership"]) == 24 and set("".join(out["membership"])) <= set("#.")
    assert out["snapshot"].any()
    assert 0 < out["mahppo"]["n_active"] <= out["env"].params.n_ue
    beta = out["env"].params.beta
    for v in (out["mahppo"]["t_task"] + beta * out["mahppo"]["e_task"],
              out["greedy"]["overhead"], out["nearest"]["overhead"],
              out["loadbal"]["overhead"], out["history"][0]["reward_mean"]):
        assert np.isfinite(v)
