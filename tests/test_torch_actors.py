"""Parity of the port's flat observation, batched env, actors, critics,
GAE and AdamW with the JAX reference, from identical numpy-made inputs.

The env is the scheduling slice's mixed fleet of ``test_torch_env`` (N =
16, one server or the 3-server pool). A batched state holds E = 3 envs;
the reference steps them with ``vmap(env.step)``, the port with one call on
(E, N) leaves. Tolerances: the env's float32 physics to ``TOL`` (1e-5
relative, as ``test_torch_env``), and the batched port bit for bit against
its own single-env calls; network outputs,
log-probs and entropies to 1e-5 as ``test_torch_policy``; GAE to 1e-5 and
one AdamW step to 1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.env import mecenv as jenv
from repro.optim import adamw_update as jadamw_update
from repro.optim import global_norm as jglobal_norm
from repro.rl import mahppo as jmahppo
from repro.rl import nets as jnets
from repro.rl.gae import gae as jgae
from repro_torch import weights
from repro_torch.env import mecenv
from repro_torch.optim import adamw_update, global_norm
from repro_torch.rl import mahppo, nets
from repro_torch.rl.gae import gae

from test_torch_env import N, TOL, _actions, _envs, _jstate, _states, _tstate
from test_torch_policy import _dist_close, _np_tree

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

E = 3


def _batched(seeds, done_env=None):
    """(numpy leaves, reference state, port state) of len(seeds) envs; the
    env ``done_env`` has no task left, so its frame ends the episode."""
    arrs = [list(_states(s)) for s in seeds]
    if done_env is not None:
        arrs[done_env][0][:] = 0.0
        arrs[done_env][1][:] = 0.0
        arrs[done_env][2][:] = 0.0
    k, l, n, d = (np.stack([a[i] for a in arrs]) for i in range(4))
    js = jenv.EnvState(k=jnp.asarray(k), l=jnp.asarray(l), n=jnp.asarray(n), d=jnp.asarray(d),
                       t=jnp.full((len(seeds),), 3, jnp.int32),
                       key=jnp.zeros((len(seeds), 2), jnp.uint32),
                       active=jnp.ones((len(seeds), N), bool))
    s = mecenv.EnvState(k=torch.from_numpy(k), l=torch.from_numpy(l), n=torch.from_numpy(n),
                        d=torch.from_numpy(d), t=torch.full((len(seeds),), 3, dtype=torch.int32),
                        gen=torch.Generator().manual_seed(0),
                        active=torch.ones((len(seeds), N), dtype=torch.bool))
    return arrs, js, s


def _row(s, e):
    """Env e of a batched port state, as a single-env state."""
    return mecenv.EnvState(k=s.k[e], l=s.l[e], n=s.n[e], d=s.d[e], t=s.t[e],
                           gen=torch.Generator().manual_seed(0), active=s.active[e])


def _batched_actions(v, n_servers, seeds):
    acts = [_actions(s, v, n_servers) for s in seeds]
    ja = {k: jnp.stack([a[0][k] for a in acts]) for k in acts[0][0]}
    ta = {k: torch.stack([a[1][k] for a in acts]) for k in acts[0][1]}
    return ja, ta


@pytest.mark.parametrize("n_servers", [1, 3])
def test_observe_agrees(n_servers):
    jv, v = _envs(n_servers)
    assert v.obs_dim == jv.obs_dim == 4 * N
    for seed in range(3):
        arrs = _states(seed)
        got = v.observe(_tstate(arrs))
        assert got.shape == (4 * N,)
        np.testing.assert_allclose(got.numpy(), np.asarray(jv.observe(_jstate(arrs))), **TOL)


@pytest.mark.parametrize("n_servers", [1, 3])
def test_batched_env_matches_single_env_and_the_vmapped_reference(n_servers):
    """One (E, N) call against E single-env calls and the reference's
    vmap, on a frame where no env resets and on one where env 1 ends its
    episode (its auto-reset draws differ from the reference's, and a
    batched draw from the single-env one, so only its flag is compared)."""
    jv, v = _envs(n_servers)
    same = np.testing.assert_array_equal
    seeds = (0, 1, 2)
    for done_env in (None, 1):
        _, js, s = _batched(seeds, done_env)
        ja, a = _batched_actions(v, n_servers, seeds)
        nxt, r, done, info = v.step(s, a)
        jn, jr, jdone, jinfo = jax.vmap(jv.step)(js, ja)
        t, e_ = v.task_overhead(s, a)
        jt, je = jax.vmap(jv.task_overhead)(js, ja)
        assert r.shape == done.shape == (E,) and nxt.k.shape == (E, N) and nxt.t.shape == (E,)
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        assert bool(done[1]) == (done_env == 1) and not bool(done[0]) and not bool(done[2])
        for e in range(E):
            one = _row(s, e)
            a1 = {k: x[e] for k, x in a.items()}
            n1, r1, d1, i1 = v.step(one, a1)
            assert bool(d1) == bool(done[e])
            same(r[e].numpy(), r1.numpy())
            for key, val in i1.items():
                same(info[key][e].numpy(), val.numpy(), err_msg=key)
            t1, e1 = v.task_overhead(one, a1)
            same(t[e].numpy(), t1.numpy())
            same(e_[e].numpy(), e1.numpy())
            if bool(done[e]):
                assert int(nxt.t[e]) == 0 and bool((nxt.k[e] >= 0).all())
                continue
            for f in ("k", "l", "n", "d"):
                same(getattr(nxt, f)[e].numpy(), getattr(n1, f).numpy(), err_msg=f)
            assert int(nxt.t[e]) == int(n1.t) == 4
            for fn in (v.observe, v.observe_per_ue):
                same(fn(s)[e].numpy(), fn(one).numpy(), err_msg=fn.__name__)
            ent, ent1 = v.observe_entities(s), v.observe_entities(one)
            for key in ent1:
                same(ent[key][e].numpy(), ent1[key].numpy(), err_msg=key)
        keep = ~done.numpy()
        if done_env is None:      # the reference on the frame where no env resets
            np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-5)
            for f in ("k", "l", "n", "d"):
                np.testing.assert_allclose(getattr(nxt, f).numpy(), np.asarray(getattr(jn, f)),
                                           err_msg=f, **TOL)
            for key in ("completed", "energy", "rate_mean", "offloads", "n_active"):
                np.testing.assert_allclose(info[key].numpy(), np.asarray(jinfo[key]),
                                           rtol=1e-5, err_msg=key)
        assert keep.sum() >= 2
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-5)
        np.testing.assert_allclose(e_.numpy(), np.asarray(je), rtol=1e-5)
        for fn, jfn in ((v.observe, jv.observe), (v.observe_per_ue, jv.observe_per_ue)):
            np.testing.assert_allclose(fn(s).numpy(), np.asarray(jax.vmap(jfn)(js)), **TOL)
        want, got = jax.vmap(jv.observe_entities)(js), v.observe_entities(s)
        for key in ("ue", "server", "edge"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL)


def test_batched_reset():
    _, v = _envs(3)
    s = v.reset(torch.Generator().manual_seed(1), n_envs=E)
    assert s.k.shape == s.d.shape == s.active.shape == (E, N) and s.t.shape == (E,)
    assert ((s.d >= 1.0) & (s.d <= 100.0)).all() and s.active.all()
    assert not torch.equal(s.k[0], s.k[1])            # each env its own draw
    s = v.reset(eval_mode=True, n_envs=E)
    assert (s.k == 200.0).all() and (s.d == 50.0).all()


@functools.lru_cache(maxsize=None)
def _jax_agent(mode, n_servers=3):
    jv, _ = _envs(n_servers)
    flags = {"shared": dict(shared_policy=True), "entity": dict(entity_policy=True)}.get(mode, {})
    return jax.jit(lambda k: jmahppo.init_agent(k, jv, **flags))(jax.random.PRNGKey(5))


def _batch_states(seeds):
    _, js, s = _batched(seeds)
    return js, s


@torch.no_grad()
@pytest.mark.parametrize("mode", ["actors", "shared", "entity"])
def test_actors_and_critics_agree(mode):
    """Every actor and critic with reference parameters loaded, over a batch
    of B = 4 states: the per-UE stack (``_policy_all``'s vmap over actors),
    the shared actor, the entity actor's one-pass dist and value; then
    ``log_prob`` and ``entropy`` on (B, N) with some actors inactive."""
    jv, v = _envs(3)
    jspace, space = jv.action_space, v.action_space
    jagent = _jax_agent(mode)
    agent = weights.agent_from_jax(_np_tree(jagent), "cpu")
    key = {"actors": "actors", "shared": "actor", "entity": "entity_actor"}[mode]
    assert set(agent) == {key, "critic"}
    assert nets.param_count(agent[key]) == jnets.param_count(jagent[key])
    assert nets.param_count(agent["critic"]) == jnets.param_count(jagent["critic"])
    js, s = _batch_states((0, 1, 2, 3))
    jm = jv.action_masks()
    full = jspace.broadcast_masks(jm, N)
    m = v.action_masks()
    mfull = space.broadcast_masks(m, N)
    if mode == "actors":
        jdist = jax.vmap(lambda o: jmahppo._policy_all(jagent["actors"], jspace, o, jm))(
            jax.vmap(jv.observe)(js))
        dist = nets.actor_forward(agent["actors"], space, v.observe(s), m)
        jval = jax.vmap(lambda o: jnets.critic_forward(jagent["critic"], o))(
            jax.vmap(jv.observe)(js))
        val = nets.critic_forward(agent["critic"], v.observe(s))
    elif mode == "shared":
        jrows = jax.vmap(jv.observe_per_ue)(js)
        jdist = jax.vmap(lambda o: jnets.shared_actor_forward(jagent["actor"], jspace, o,
                                                              full))(jrows)
        rows = v.observe_per_ue(s)
        dist = nets.shared_actor_forward(agent["actor"], space, rows, mfull)
        jval = jax.vmap(lambda o: jnets.critic_forward(jagent["critic"], o.mean(0)))(jrows)
        val = nets.critic_forward(agent["critic"], rows.mean(dim=-2))
    else:
        jdist, jval = jax.vmap(lambda o: jnets.entity_policy_value(
            jagent["entity_actor"], jagent["critic"], jspace, o, full))(
            jax.vmap(jv.observe_entities)(js))
        dist, val = nets.entity_policy_value(agent["entity_actor"], agent["critic"], space,
                                             v.observe_entities(s), mfull)
    _dist_close(dist, jdist)
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=1e-5, atol=1e-5)
    assert dist["split"].shape == (4, N, v.n_actions_b) and val.shape == (4,)
    rng = np.random.default_rng(7)
    acts = {h.name: rng.integers(0, h.n, (4, N)) for h in space.discrete}
    acts["power"] = rng.standard_normal((4, N)).astype(np.float32)
    active = (rng.random((4, N)) < 0.8).astype(np.float32)
    jacts = {k: jnp.asarray(x) for k, x in acts.items()}
    tacts = {k: torch.from_numpy(x) for k, x in acts.items()}
    jlp = jax.vmap(jax.vmap(jspace.log_prob))(jdist, jacts, jnp.asarray(active))
    lp = space.log_prob(dist, tacts, torch.from_numpy(active))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
    jent = jax.vmap(jax.vmap(jspace.entropy))(jdist, jnp.asarray(active))
    np.testing.assert_allclose(space.entropy(dist, torch.from_numpy(active)).numpy(),
                               np.asarray(jent), rtol=1e-5, atol=1e-5)


def test_actor_stack_is_n_independent_actors():
    """The stack's actor i is ``init_actor``'s layout with weights w[i]:
    evaluating one slice alone gives row i of the stacked output."""
    _, v = _envs(1)
    stack = nets.init_actor_stack(torch.Generator().manual_seed(0), 3, v.obs_dim,
                                  v.action_space)
    assert stack.trunk.layers[0].w.shape == (3, v.obs_dim, 256)
    assert stack.heads["split"].layers[1].w.shape == (3, 64, v.n_actions_b)
    obs = torch.randn(2, v.obs_dim, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        dist = nets.actor_forward(stack, v.action_space, obs)
        for i in range(3):
            one = nets.Actor(
                nets.MLP([nets.Linear(l.w[i], l.b[i]) for l in stack.trunk.layers]),
                torch.nn.ModuleDict({k: nets.MLP([nets.Linear(l.w[i], l.b[i])
                                                  for l in h.layers])
                                     for k, h in stack.heads.items()}))
            d1 = nets.actor_forward(one, v.action_space, obs)
            torch.testing.assert_close(dist["split"][:, i], d1["split"], rtol=1e-6, atol=1e-7)
            torch.testing.assert_close(dist["power"]["mu"][:, i], d1["power"]["mu"],
                                       rtol=1e-6, atol=1e-7)


def test_gae_agrees():
    rng = np.random.default_rng(3)
    T, n_envs = 40, 4
    r = rng.standard_normal((T, n_envs)).astype(np.float32)
    val = rng.standard_normal((T, n_envs)).astype(np.float32)
    done = rng.random((T, n_envs)) < 0.1
    last = rng.standard_normal(n_envs).astype(np.float32)
    ja, jr = jgae(jnp.asarray(r), jnp.asarray(val), jnp.asarray(done), jnp.asarray(last),
                  gamma=0.95, lam=0.9)
    a, rt = gae(torch.from_numpy(r), torch.from_numpy(val), torch.from_numpy(done),
                torch.from_numpy(last), gamma=0.95, lam=0.9)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rt.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_update_agrees(weight_decay):
    """One step from the same mid-run state (step 3, nonzero moments), with
    and without decay (which only leaves of two or more dims take)."""
    rng = np.random.default_rng(4)
    shapes = [(5, 7), (7,), (3, 4, 2), ()]
    arr = lambda sh, s=1.0: np.asarray(rng.standard_normal(sh) * s, np.float32)
    p, g, m = [arr(sh) for sh in shapes], [arr(sh) for sh in shapes], \
        [arr(sh, 0.1) for sh in shapes]
    v = [np.asarray(np.abs(arr(sh, 0.01))) for sh in shapes]
    jp, jstate = jadamw_update(
        [jnp.asarray(x) for x in g],
        {"m": [jnp.asarray(x) for x in m], "v": [jnp.asarray(x) for x in v],
         "step": jnp.int32(3)},
        [jnp.asarray(x) for x in p], 1e-3, weight_decay=weight_decay)
    tp = [torch.from_numpy(x.copy()) for x in p]
    state = {"m": [torch.from_numpy(x.copy()) for x in m],
             "v": [torch.from_numpy(x.copy()) for x in v],
             "step": torch.tensor(3, dtype=torch.int32)}
    got, new = adamw_update([torch.from_numpy(x) for x in g], state, tp, 1e-3,
                            weight_decay=weight_decay)
    assert got is tp and int(new["step"]) == int(jstate["step"]) == 4
    for a, b in zip(got, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    for key in ("m", "v"):
        for a, b in zip(new[key], jstate[key]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(global_norm([torch.from_numpy(x) for x in g])),
                               float(jglobal_norm([jnp.asarray(x) for x in g])), rtol=1e-6)
