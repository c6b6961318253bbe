"""The pair scorer with an env axis and its gradient, against the JAX
reference, and MAHPPO training through it (``fused_scorer``) over
resampled pool geometry (``randomize_pool``).

On CPU tensors ``pair_scorer.PairScorer`` runs the forward twin (one call
an env) and the backward formula ``pair_scorer_backward_plain``; the
reference differentiates ``pair_scorer_xla`` (its decomposed XLA form,
``vmap``-ed over envs). Inputs are made with numpy at the training path's
magnitudes (slowness in s/FLOP, so every edge feature is O(1) and the
hidden layer does not saturate). Tolerances: the forward 1e-5, the
reference kernel's (``tests/test_kernels.py``); each gradient within 1e-5
of its largest magnitude; ``gradcheck`` in float64. The training path runs
on the demo's env (the mixed fleet, 2 servers, ``random_pool_ranges(2)``)
at ``test_torch_train``'s small configuration; its tolerances are stated
where they are used.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fleets as jfleets
from repro.env import mecenv as jenv
from repro.kernels import pair_scorer as jps
from repro.optim import adamw_init as jadamw_init
from repro.rl import mahppo as jmahppo
from repro_torch import weights
from repro_torch.core import fleets
from repro_torch.env import mecenv
from repro_torch.kernels import ops, pair_scorer
from repro_torch.optim import adamw_init
from repro_torch.rl import mahppo

from test_torch_policy import _np_tree
from test_torch_train import CFG, _cells, _flat_batch, _jpaths, _paths, _torch

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

GRADS = (0, 6, 7, 8, 9, 10, 11)        # ue_emb and the weights take gradients
FLAGS = dict(entity_policy=True, fused_scorer=True, randomize_pool=True)


def _inputs(seed, b, n, e, d_ue=128, s_dim=32, hid=48):
    """(ue_emb, d, work, active, geom, consts, w_srv, b_srv, w1, b1, w2, b2)
    as float32 numpy, with an env axis of ``b`` on the first five."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    lo, hi = fleets.random_pool_ranges(e)
    return [f(np.tanh(rng.standard_normal((b, n, d_ue)))), f(rng.uniform(1.0, 100.0, (b, n))),
            f(rng.uniform(1e8, 5e9, (b, n))), f(rng.random((b, n)) < 0.7),
            f(lo + rng.random((b, e, 3)) * (hi - lo)),
            f([3.0, 0.5, 1e-9, 0.1, 0.5, e * 2.0, 100.0, 1e12]),
            f(rng.standard_normal((4, s_dim)) * 0.5), f(rng.standard_normal(s_dim) * 0.1),
            f(rng.standard_normal((d_ue + s_dim + 3, hid)) * 0.1),
            f(rng.standard_normal(hid) * 0.1), f(rng.standard_normal((hid, 1)) * 0.3),
            f(rng.standard_normal(1))]


def _jax_batched(args):
    """The reference's scorer over the env axis, as its vmap gives it."""
    return jax.vmap(jps.pair_scorer_xla, in_axes=(0,) * 5 + (None,) * 7)(*args)


@pytest.mark.parametrize("b,n,e", [(4, 4, 2), (3, 13, 3), (2, 9, 1), (1, 20, 5)])
def test_batched_forward_equals_single_calls_and_the_reference(b, n, e):
    arrs = _inputs(b * 10 + n, b, n, e)
    t = [torch.from_numpy(a) for a in arrs]
    logits, srv = pair_scorer.pair_scorer(*t)
    assert logits.shape == (b, n, e) and srv.shape == (b, e, 32)
    for i in range(b):
        one = pair_scorer.pair_scorer(*(x[i] for x in t[:5]), *t[5:])
        assert torch.equal(logits[i], one[0]) and torch.equal(srv[i], one[1])
    want_l, want_s = _jax_batched([jnp.asarray(a) for a in arrs])
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_l), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(srv.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)


def _hold(got, want, rel=1e-5):
    for i, (a, w) in enumerate(zip(got, want)):
        a, w = np.asarray(a, np.float64), np.asarray(w, np.float64)
        assert a.shape == w.shape, i
        np.testing.assert_allclose(a, w, rtol=0, atol=rel * np.abs(w).max(), err_msg=str(i))


@pytest.mark.parametrize("b,n,e", [(4, 4, 2), (16, 4, 2), (2, 13, 3), (1, 40, 5)])
def test_backward_formula_matches_the_reference_vjp(b, n, e):
    arrs = _inputs(b + n + e, b, n, e)
    rng = np.random.default_rng(7)
    g_l = rng.standard_normal((b, n, e)).astype(np.float32)
    g_s = rng.standard_normal((b, e, 32)).astype(np.float32)
    j = [jnp.asarray(a) for a in arrs]

    def f(*diff):
        full = list(j)
        for i, x in zip(GRADS, diff):
            full[i] = x
        return _jax_batched(full)

    _, vjp = jax.vjp(f, *(j[i] for i in GRADS))
    want = vjp((jnp.asarray(g_l), jnp.asarray(g_s)))
    got = pair_scorer.pair_scorer_backward_plain(torch.from_numpy(g_l), torch.from_numpy(g_s),
                                                 *(torch.from_numpy(a) for a in arrs))
    assert all(float(np.abs(np.asarray(w)).max()) > 0 for w in want)
    _hold([x.numpy() for x in got], want)
    # the Function's backward on CPU tensors is this formula
    t = [torch.from_numpy(a).requires_grad_(i in GRADS) for i, a in enumerate(arrs)]
    logits, srv = pair_scorer.PairScorer.apply(*t)
    auto = torch.autograd.grad((logits * torch.from_numpy(g_l)).sum()
                               + (srv * torch.from_numpy(g_s)).sum(), [t[i] for i in GRADS])
    assert all(torch.equal(x, y) for x, y in zip(auto, got))


def test_gradcheck_in_float64():
    arrs = _inputs(3, 2, 5, 3, d_ue=8, s_dim=4, hid=6)
    t = [torch.from_numpy(a).double().requires_grad_(i in GRADS) for i, a in enumerate(arrs)]
    assert torch.autograd.gradcheck(pair_scorer.PairScorer.apply, t, eps=1e-6, atol=1e-7,
                                    rtol=1e-5)


def test_bf16_observations_get_their_gradient_in_their_dtype():
    arrs = _inputs(4, 3, 6, 2)
    t = [torch.from_numpy(a) for a in arrs]
    t[:5] = [x.to(torch.bfloat16) for x in t[:5]]
    ue = t[0].clone().requires_grad_(True)
    logits, _ = ops.pair_scorer(ue, dict(zip(("d", "work", "active", "geom", "consts"), t[1:6])),
                                {"w": t[6], "b": t[7]},
                                [{"w": t[8], "b": t[9]}, {"w": t[10], "b": t[11]}])
    assert logits.dtype == torch.float32
    (g,) = torch.autograd.grad(logits.sum(), [ue])
    assert g.dtype == torch.bfloat16 and g.shape == ue.shape


# ------------------------------------------------------------- training
@functools.lru_cache(maxsize=None)
def _envs():
    jv = jenv.MECEnv(jenv.make_env_params(
        jfleets.make_mixed_fleet("qwen3-1.7b", 4), n_channels=2, t0=0.5,
        pool=jfleets.make_edge_pool(2), pool_ranges=jfleets.random_pool_ranges(2)))
    v = mecenv.MECEnv(mecenv.make_env_params(
        fleets.make_mixed_fleet("qwen3-1.7b", 4), n_channels=2, t0=0.5,
        pool=fleets.make_edge_pool(2), pool_ranges=fleets.random_pool_ranges(2), device="cpu"))
    return jv, v


@functools.lru_cache(maxsize=None)
def _setup():
    """The reference's closures, an entity agent and a trajectory collected
    over randomized geometry through the fused scorer."""
    jv, v = _envs()
    jcfg = jmahppo.MAHPPOConfig(**CFG, **FLAGS)
    cells = _cells(jmahppo.make_train_fns(jv, jcfg).__wrapped__)
    ref = {"update": cells["update"], "loss_fn": _cells(cells["update"])["loss_fn"],
           "collect": cells["collect"]}
    jagent = jax.jit(lambda k: jmahppo.init_agent(k, jv, entity_policy=True))(
        jax.random.PRNGKey(1))
    jstates = jmahppo.init_states(jv, jcfg, jax.random.PRNGKey(2))
    _, _, traj, last_v = jax.jit(ref["collect"])(jagent, jax.random.PRNGKey(3), jstates)
    cfg = mahppo.MAHPPOConfig(**CFG, **FLAGS)
    return jv, v, jcfg, ref, jagent, traj, last_v, cfg, mahppo.make_train_fns(v, cfg)


def test_trajectory_carries_each_env_s_drawn_geometry():
    jv, _, jcfg, _, _, traj, _, _, _ = _setup()
    geom = np.asarray(traj["obs"]["raw"]["geom"])              # (T, E, 2, 3)
    assert geom.shape == (CFG["horizon"] // CFG["n_envs"], CFG["n_envs"], 2, 3)
    assert not np.allclose(geom[0, 0], geom[0, 1])            # the envs' draws differ


def test_loss_gradients_through_the_fused_scorer_agree():
    """``loss_fn``'s gradient leaf by leaf from the same agent and the
    reference's minibatch (geometry of every sample its env's draw): each
    leaf within 1e-4 of its largest gradient. The reference states no
    gradient tolerance; float32 sums over the minibatch's pairs, the
    scorer's and the heads', round differently in the two packages, so
    this is 10 times the forward's. The scorer's last bias adds one
    constant to every route logit, which the route softmax and the
    attention context do not see: its gradient is zero in exact arithmetic
    and is held to an absolute 1e-6."""
    jv, v, jcfg, ref, jagent, traj, last_v, _, fns = _setup()
    flat, m = _flat_batch(jcfg, traj, last_v, v.params.n_ue)
    idx = jax.random.choice(jax.random.PRNGKey(4), m, (jcfg.batch,), replace=False)
    jmb = jax.tree_util.tree_map(lambda x: x[idx], flat)
    (jtotal, _), jgrads = jax.jit(jax.value_and_grad(ref["loss_fn"], has_aux=True))(jagent, jmb)
    agent = weights.agent_from_jax(_np_tree(jagent), "cpu")
    total, _ = fns.loss_fn(agent, _torch(_np_tree(jmb)))
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5, atol=1e-6)
    params = _paths(agent)
    grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
    want = _jpaths(jgrads)
    assert set(grads) == set(want)
    shift = ("entity_actor", "scorer", 1, "b")
    for path, g in grads.items():
        if path == shift:
            assert np.abs(g.numpy()).max() <= 1e-6 and np.abs(want[path]).max() <= 1e-6
            continue
        scale = np.abs(want[path]).max()
        assert scale > 0, path
        np.testing.assert_allclose(g.numpy(), want[path], rtol=0, atol=1e-4 * scale,
                                   err_msg=str(path))


def test_update_through_the_fused_scorer_agrees():
    """One ``update`` (20 AdamW steps, the reference's minibatch indices):
    each parameter's change within 1e-3 of its leaf's largest change, the
    bound and its reasons of ``test_torch_train.test_update_agrees``; the
    scorer's last bias to AdamW's bound of lr a step."""
    _, _, jcfg, ref, jagent, traj, last_v, cfg, fns = _setup()
    key = jax.random.PRNGKey(6)
    new_agent, _, _ = jax.jit(ref["update"])(jagent, jadamw_init(jagent), key, traj, last_v)
    n_updates = cfg.reuse * max(CFG["horizon"] // cfg.batch, 1)
    idx = [torch.from_numpy(np.array(jax.random.choice(k, CFG["horizon"], (cfg.batch,),
                                                         replace=False))).long()
           for k in jax.random.split(key, n_updates)]
    agent = weights.agent_from_jax(_np_tree(jagent), "cpu")
    before = {p: t.detach().clone() for p, t in _paths(agent).items()}
    fns.update(agent, adamw_init(mahppo.agent_parameters(agent)), None,
               _torch(_np_tree(traj)), _torch(np.asarray(last_v)), indices=idx)
    old, new = _jpaths(jagent), _jpaths(new_agent)
    for path, t in _paths(agent).items():
        want, got = new[path] - old[path], (t.detach() - before[path]).numpy()
        if path == ("entity_actor", "scorer", 1, "b"):
            assert np.abs(got).max() <= n_updates * cfg.lr * (1 + 1e-5)
            continue
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max(),
                                   err_msg=str(path))


def test_training_through_the_fused_scorer_runs_on_the_cpu():
    _, v = _envs()
    cfg = mahppo.MAHPPOConfig(iterations=2, **CFG, **FLAGS)
    _, hist = mahppo.train_mahppo(v, cfg, seed=0)
    assert len(hist) == 2 and all(np.isfinite(r["reward_mean"]) for r in hist)
    states = mahppo.init_states(v, cfg, torch.Generator().manual_seed(1))
    assert states.geom.shape == (CFG["n_envs"], 2, 3)
