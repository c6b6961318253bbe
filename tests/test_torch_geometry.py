"""Parity of the port's resampled pool geometry with the JAX reference.

The env is ``test_torch_env``'s mixed fleet (N = 16) on the 3-server demo
pool, built with ``random_pool_ranges(3)``. Geometry drawn with numpy
inside the ranges is injected into both packages' states, on a single env
and with an env axis of 4 (the reference ``vmap``s its step): the step,
the per-task overhead and both entity observations must then agree. The
physics are float32 on both sides and agree to 1e-6 relative (their pow,
log2 and interference sums round differently in the last bits; 1e-6 of
the reward, 2e-6 at most of a single rate); completions are equal. The
draws are checked for their range and their first two moments.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fleets as jfleets
from repro.env import mecenv as jenv
from repro_torch.core import fleets
from repro_torch.env import mecenv

from test_torch_env import N, _actions, _fleets, _states

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

E = 3
TOL = dict(rtol=1e-6, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _envs():
    jfleet, fleet = _fleets()
    jv = jenv.MECEnv(jenv.make_env_params(jfleet, n_channels=2, pool=jfleets.make_edge_pool(E),
                                          pool_ranges=jfleets.random_pool_ranges(E)))
    v = mecenv.MECEnv(mecenv.make_env_params(fleet, n_channels=2, pool=fleets.make_edge_pool(E),
                                             pool_ranges=fleets.random_pool_ranges(E),
                                             device="cpu"))
    return jv, v


def _geom(seed, lead=()):
    lo, hi = fleets.random_pool_ranges(E)
    u = np.random.default_rng(50 + seed).random((*lead, E, 3))
    return (lo + u * (hi - lo)).astype(np.float32)


def _pair(seeds):
    """Both packages' states of the given seeds (one env, or an env axis
    when ``seeds`` is a list), each with its own injected geometry."""
    one = not isinstance(seeds, list)
    seeds = [seeds] if one else seeds
    arrs = [_states(s) for s in seeds]
    k, l, n, d = (np.stack(x) for x in zip(*arrs))
    g = np.stack([_geom(s) for s in seeds])
    if one:
        k, l, n, d, g = k[0], l[0], n[0], d[0], g[0]
    lead = k.shape[:-1]
    js = jenv.EnvState(k=jnp.asarray(k), l=jnp.asarray(l), n=jnp.asarray(n), d=jnp.asarray(d),
                       t=jnp.full(lead, 3, jnp.int32), key=jnp.zeros((*lead, 2), jnp.uint32),
                       active=jnp.ones(k.shape, bool), geom=jnp.asarray(g))
    ts = mecenv.EnvState(k=torch.from_numpy(k), l=torch.from_numpy(l), n=torch.from_numpy(n),
                         d=torch.from_numpy(d), t=torch.full(lead, 3, dtype=torch.int32),
                         gen=torch.Generator().manual_seed(0),
                         active=torch.ones(k.shape, dtype=torch.bool), geom=torch.from_numpy(g))
    return js, ts


def _batched_actions(seeds, v):
    acts = [_actions(s, v, E) for s in seeds]
    return ({k: jnp.stack([a[0][k] for a in acts]) for k in acts[0][0]},
            {k: torch.stack([a[1][k] for a in acts]) for k in acts[0][1]})


def _vmapped(fn, batched):
    return jax.vmap(fn) if batched else fn


@pytest.mark.parametrize("batched", [False, True])
def test_step_and_task_overhead_follow_the_geometry(batched):
    jv, v = _envs()
    seeds = [0, 1, 2, 3] if batched else 1
    js, s = _pair(seeds)
    ja, a = _batched_actions(seeds, v) if batched else _actions(seeds, v, E)
    jn, jr, jdone, jinfo = _vmapped(jv.step, batched)(js, ja)
    nxt, r, done, info = v.step(s, a)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert not bool(done.any())
    for f in ("k", "l", "n", "d"):
        np.testing.assert_allclose(getattr(nxt, f).numpy(), np.asarray(getattr(jn, f)),
                                   err_msg=f, **TOL)
    np.testing.assert_array_equal(nxt.k.numpy(), np.asarray(jn.k))
    assert torch.equal(nxt.geom, s.geom) and np.array_equal(np.asarray(jn.geom), s.geom.numpy())
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6)
    for key in ("completed", "offloads", "n_active", "server_load"):
        np.testing.assert_array_equal(info[key].numpy(), np.asarray(jinfo[key]), err_msg=key)
    for key in ("energy", "rate_mean"):
        np.testing.assert_allclose(info[key].numpy(), np.asarray(jinfo[key]), rtol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(info["eps_bits"].numpy(), np.asarray(jinfo["eps_bits"]),
                               atol=1e-3)
    jt, je = _vmapped(jv.task_overhead, batched)(js, ja)
    t, e = v.task_overhead(s, a)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=2e-6)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=2e-6)
    # the drawn geometry moves the physics: the static pool gives other rates
    static = s._replace(geom=None)
    assert not torch.allclose(v.task_overhead(static, a)[0], t)


@pytest.mark.parametrize("batched", [False, True])
def test_entity_observations_follow_the_geometry(batched):
    jv, v = _envs()
    js, s = _pair([4, 5, 6, 7] if batched else 4)
    want, got = _vmapped(jv.observe_entities, batched)(js), v.observe_entities(s)
    for key in ("ue", "server", "edge"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **TOL)
    want, got = _vmapped(jv.observe_entities_raw, batched)(js), v.observe_entities_raw(s)
    np.testing.assert_allclose(got["ue"].numpy(), np.asarray(want["ue"]), **TOL)
    for key in ("d", "work", "active", "geom"):
        assert got["raw"][key].shape == want["raw"][key].shape, key
        np.testing.assert_array_equal(got["raw"][key].numpy(), np.asarray(want["raw"][key]))
    assert got["raw"]["consts"].shape == want["raw"]["consts"].shape
    np.testing.assert_allclose(got["raw"]["consts"].numpy(), np.asarray(want["raw"]["consts"]),
                               rtol=2.4e-7)


def test_draws_lie_in_the_ranges_and_are_uniform():
    _, v = _envs()
    lo, hi = (np.asarray(a, np.float64) for a in fleets.random_pool_ranges(E))
    s = v.reset(torch.Generator().manual_seed(3), n_envs=4096, randomize=True)
    assert s.geom.shape == (4096, E, 3) and s.k.shape == (4096, N)
    g = s.geom.numpy().astype(np.float64)
    assert (g >= lo).all() and (g <= hi).all()
    u = (g - lo) / np.where(hi > lo, hi - lo, 1.0)
    # U(0, 1): mean 1/2 (sd 0.0045 over 4096), variance 1/12 (sd 0.0013)
    assert np.abs(u.mean(axis=0) - 0.5).max() < 0.02
    assert np.abs(u.var(axis=0) - 1 / 12).max() < 0.006
    one = v.reset(torch.Generator().manual_seed(4), randomize=True)
    assert one.geom.shape == (E, 3) and v.reset(eval_mode=True).geom is None


def test_auto_reset_redraws_only_the_envs_that_ended():
    _, v = _envs()
    s = v.reset(torch.Generator().manual_seed(5), n_envs=4, randomize=True)
    k = s.k.clone()
    k[1] = 0.0
    k[3] = 0.0                         # these two episodes end this frame
    s = s._replace(k=k)
    a = {"split": torch.full((4, N), v.n_actions_b - 1), "channel": torch.zeros((4, N)),
         "route": torch.zeros((4, N)), "power": torch.full((4, N), 0.1)}
    nxt, _, done, _ = v.step(s, a)
    assert done.tolist() == [False, True, False, True]
    for i in range(4):
        assert torch.equal(nxt.geom[i], s.geom[i]) == (not bool(done[i])), i
    lo, hi = (torch.from_numpy(x) for x in fleets.random_pool_ranges(E))
    assert bool(((nxt.geom >= lo) & (nxt.geom <= hi)).all())


def test_pool_ranges_are_checked_as_the_reference_checks_them():
    jfleet, fleet = _fleets()
    for pool, ranges in ((None, fleets.random_pool_ranges(E)),
                         (fleets.make_edge_pool(2), fleets.random_pool_ranges(E))):
        jpool = None if pool is None else jfleets.make_edge_pool(pool.n_servers)
        with pytest.raises(ValueError) as want:
            jenv.make_env_params(jfleet, pool=jpool, pool_ranges=ranges)
        with pytest.raises(ValueError) as got:
            mecenv.make_env_params(fleet, pool=pool, pool_ranges=ranges, device="cpu")
        assert str(got.value) == str(want.value)
    _, v = _envs()
    static = mecenv.MECEnv(mecenv.make_env_params(fleet, pool=fleets.make_edge_pool(E),
                                                  device="cpu"))
    assert v.randomizable and not static.randomizable
    with pytest.raises(ValueError, match="pool_ranges"):
        static.reset(torch.Generator(), randomize=True)
