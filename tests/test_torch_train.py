"""Parity of the port's MAHPPO training with the JAX reference, and the
quickstart twin.

The reference's training functions are closures of ``make_train_fns``; the
tests read them from the cells of the jitted iteration's Python function
(``iteration.__wrapped__``): ``iteration`` -> ``update`` -> ``loss_fn``,
and ``iteration`` -> ``collect`` -> ``sample_step``. Nothing of the
reference is edited. Agents are drawn by the reference and carried into the
port by ``repro_torch.weights.agent_from_jax``; trajectories are collected
by the reference and fed to both packages.

The per-UE actors run on the quickstart's env (qwen3-1.7b's split table, 5
UEs on 2 channels); the shared and entity actors on the 3-server pool of
``test_torch_env`` (N = 16), so the route head is covered. Tolerances are
stated in each test.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.split import transformer_split_table as jsplit_table
from repro.env import mecenv as jenv
from repro.optim import adamw_init as jadamw_init
from repro.rl import baselines as jbaselines
from repro.rl import mahppo as jmahppo
from repro.rl.gae import gae as jgae
from repro_torch import weights
from repro_torch.env import mecenv
from repro_torch.launch import quickstart
from repro_torch.optim import adamw_init
from repro_torch.rl import baselines, mahppo

from test_torch_env import _envs
from test_torch_policy import _np_tree

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

CFG = dict(horizon=64, n_envs=2, batch=32)      # T = 32 steps, M = 64, 20 updates
FLAGS = {"actors": {}, "shared": dict(shared_policy=True),
         "entity": dict(entity_policy=True)}
SCALE = 300.0
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _quickstart_envs():
    plan = jsplit_table(jget_config("qwen3-1.7b"))
    t_full, e_full = float(plan.t_local[-1]), float(plan.e_local[-1])
    jv = jenv.MECEnv(jenv.make_env_params(plan, n_ue=5, n_channels=2,
                                          t0=max(0.5, round(10 * t_full, 1)),
                                          beta=t_full / max(e_full, 1e-9)))
    return jv, quickstart.quickstart_env("qwen3-1.7b", 5, "cpu")[1]


def _mode_envs(mode):
    return _quickstart_envs() if mode == "actors" else _envs(3)


def _cells(fn):
    """A function's closure as {name: value}, the cells that are set."""
    out = {}
    for name, cell in zip(fn.__code__.co_freevars, fn.__closure__ or ()):
        try:
            out[name] = cell.cell_contents
        except ValueError:
            pass
    return out


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _port_states(js):
    return mecenv.EnvState(k=_torch(js.k), l=_torch(js.l), n=_torch(js.n), d=_torch(js.d),
                           t=_torch(js.t), gen=torch.Generator().manual_seed(9),
                           active=_torch(js.active))


def _paths(agent):
    """The port agent's parameters keyed by their reference pytree path."""
    out = {}
    for key, mod in agent.items():
        for name, p in mod.named_parameters():
            out[(key,) + tuple(int(t) if t.isdigit() else t
                               for t in name.split(".") if t != "layers")] = p
    return out


def _jpaths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): np.asarray(x)
            for path, x in flat}


@functools.lru_cache(maxsize=None)
def _setup(mode):
    """The reference's closures, an agent and a collected trajectory."""
    jv, v = _mode_envs(mode)
    jcfg = jmahppo.MAHPPOConfig(**CFG, **FLAGS[mode])
    cells = _cells(jmahppo.make_train_fns(jv, jcfg).__wrapped__)
    ref = {"update": cells["update"], "collect": cells["collect"],
           "loss_fn": _cells(cells["update"])["loss_fn"],
           "sample_step": _cells(cells["collect"])["sample_step"]}
    jagent = jax.jit(lambda k: jmahppo.init_agent(k, jv, **FLAGS[mode]))(
        jax.random.PRNGKey(1))
    jstates = jmahppo.init_states(jv, jcfg, jax.random.PRNGKey(2))
    _, _, traj, last_v = jax.jit(ref["collect"])(jagent, jax.random.PRNGKey(3), jstates)
    return jv, v, jcfg, ref, jagent, jstates, traj, last_v


def _port(mode):
    jv, v, jcfg, _, jagent, _, _, _ = _setup(mode)
    cfg = mahppo.MAHPPOConfig(**CFG, **FLAGS[mode])
    return v, cfg, mahppo.make_train_fns(v, cfg), weights.agent_from_jax(_np_tree(jagent),
                                                                          "cpu")


def _flat_batch(jcfg, traj, last_v, n_ue):
    """The reference update's flattened trajectory (GAE, normalized
    advantages), written out as ``mahppo.py``'s update writes it."""
    adv, ret = jgae(traj["reward"], traj["value"], traj["done"], last_v,
                    gamma=jcfg.gamma, lam=jcfg.lam)
    M = adv.shape[0] * adv.shape[1]
    flat = {"obs": jax.tree_util.tree_map(lambda x: x.reshape((M,) + x.shape[2:]),
                                          traj["obs"]),
            "actions": jax.tree_util.tree_map(lambda x: x.reshape(M, n_ue), traj["actions"]),
            "logp": traj["logp"].reshape(M, n_ue), "active": traj["active"].reshape(M, n_ue),
            "adv": adv.reshape(M), "ret": ret.reshape(M)}
    a = flat["adv"]
    flat["adv"] = (a - a.mean()) / (a.std() + 1e-8)
    return flat, M


@pytest.mark.parametrize("mode", ["actors", "shared", "entity"])
def test_sample_step_agrees(mode):
    """The port's rollout step from the reference's batched states: its
    observation and value, the log-prob of the actions it drew under the
    reference's distribution, and the reference's vmapped step under those
    actions (1e-5; the draws themselves come from another generator)."""
    jv, v, _, ref, jagent, jstates, _, _ = _setup(mode)
    _, _, fns, agent = _port(mode)
    with torch.no_grad():
        nxt, tr = fns.sample_step(agent, torch.Generator().manual_seed(0),
                                  _port_states(jstates))
    c = _cells(ref["sample_step"])
    space = jv.action_space

    @jax.jit         # one compiled call: eager, every op of the step compiles alone
    def reference(jstates, jact, active):
        jobs = c["_observe"](jstates)
        if mode == "entity":
            jdist, jval = jax.vmap(lambda o: c["_policy_value"](jagent, o, c["masks0_full"]))(
                jobs)
        else:
            masks = c["masks0_full"] if mode == "shared" else c["masks0"]
            jdist = jax.vmap(lambda o: c["_dist"](jagent, o, masks))(jobs)
            jval = jax.vmap(lambda o: c["_value"](jagent, o))(jobs)
        jlp = jax.vmap(jax.vmap(space.log_prob))(jdist, jact, active)
        return jobs, jval, jlp, jax.vmap(jv.step)(jstates, space.execute(jact))

    jact = {k: jnp.asarray(x.numpy()) for k, x in tr["actions"].items()}
    jobs, jval, jlp, (jn, jr, jdone, jinfo) = reference(jstates, jact,
                                                         jnp.asarray(tr["active"].numpy()))
    for key, want in _jpaths({"obs": jobs}).items():
        got = tr["obs"][key[1]] if mode == "entity" else tr["obs"]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr["value"].numpy(), np.asarray(jval), rtol=1e-5, atol=1e-5)
    assert bool(v.params.feasible.gather(1, tr["actions"]["split"].T).all())
    np.testing.assert_allclose(tr["logp"].numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tr["done"].numpy(), np.asarray(jdone))
    assert not bool(tr["done"].any())
    np.testing.assert_allclose(tr["reward"].numpy(), np.asarray(jr), rtol=1e-5)
    for key in ("completed", "energy"):
        np.testing.assert_allclose(tr[key].numpy(), np.asarray(jinfo[key]), rtol=1e-5)
    np.testing.assert_allclose(nxt.k.numpy(), np.asarray(jn.k), rtol=1e-5)


@pytest.mark.parametrize("mode", ["actors", "shared", "entity"])
def test_loss_and_gradients_agree(mode):
    """``loss_fn`` and its gradient, from the same agent, the reference's
    trajectory and the reference's first minibatch. The loss and its
    metrics: relative 1e-5, absolute 1e-6. Each gradient leaf: absolute
    1e-6 plus 1e-5 of the leaf's largest element, so relative 1e-5 of the
    leaf; an element of a leaf of order 10 that cancels to 1e-2 carries
    the leaf's float32 rounding (about 1e-6), not its own."""
    jv, v, jcfg, ref, jagent, _, traj, last_v = _setup(mode)
    _, _, fns, agent = _port(mode)
    flat, M = _flat_batch(jcfg, traj, last_v, v.params.n_ue)
    idx = jax.random.choice(jax.random.PRNGKey(4), M, (jcfg.batch,), replace=False)
    jmb = jax.tree_util.tree_map(lambda x: x[idx], flat)
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(ref["loss_fn"], has_aux=True))(
        jagent, jmb)
    total, metrics = fns.loss_fn(agent, _torch(_np_tree(jmb)))
    np.testing.assert_allclose(float(total.detach()), float(jtotal), **LOSS_TOL)
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), err_msg=k,
                                   **LOSS_TOL)
    params = _paths(agent)
    grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
    want = _jpaths(jgrads)
    assert set(grads) == set(want)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[path], rtol=0,
                                   atol=1e-6 + 1e-5 * np.abs(want[path]).max(),
                                   err_msg=str(path))


@pytest.mark.parametrize("mode", ["actors", "entity"])
def test_update_agrees(mode):
    """One whole ``update`` (GAE, normalized advantages, 20 AdamW steps at
    lr = 1e-4) from the same agent, fresh optimizer state and trajectory,
    with the reference's minibatch indices (its own ``split`` and
    ``choice`` calls) fed to the port. Each parameter's change must lie
    within 1e-3 of the largest change of its leaf: AdamW divides every
    element's step by the root of its own second moment, so an element
    whose gradient sits near float32 noise, or changes sign between the two
    packages' sums, moves by up to lr in either direction whatever its
    size. With 20 steps of at most lr each, a relative bound on the element
    would fail on such elements while the leaf moves as the reference's;
    1e-3 of the leaf's largest change (about 20 lr) still tells a wrong
    step, a transposed stack or a missed update apart. The entity scorer's
    last bias adds one constant to every route logit, which neither the
    route softmax nor the attention context sees: its gradient is rounding
    noise in both packages, so it is held only to the AdamW bound of lr a
    step."""
    jv, v, jcfg, ref, jagent, _, traj, last_v = _setup(mode)
    _, cfg, fns, agent = _port(mode)
    key = jax.random.PRNGKey(6)
    new_agent, new_opt, jmetrics = jax.jit(ref["update"])(jagent, jadamw_init(jagent), key,
                                                          traj, last_v)
    M = CFG["horizon"]
    n_updates = cfg.reuse * max(M // cfg.batch, 1)
    idx = [torch.from_numpy(np.array(jax.random.choice(k, M, (cfg.batch,),
                                                         replace=False))).long()
           for k in jax.random.split(key, n_updates)]
    before = {p: t.detach().clone() for p, t in _paths(agent).items()}
    opt = adamw_init(mahppo.agent_parameters(agent))
    metrics = fns.update(agent, opt, None, _torch(_np_tree(traj)), _torch(np.asarray(last_v)),
                         indices=idx)
    assert int(opt["step"]) == int(new_opt["step"]) == n_updates == 20
    old, new = _jpaths(jagent), _jpaths(new_agent)
    shift = ("entity_actor", "scorer", 1, "b")
    for path, t in _paths(agent).items():
        want = new[path] - old[path]
        got = (t.detach() - before[path]).numpy()
        if path == shift:
            assert np.abs(got).max() <= n_updates * cfg.lr * (1 + 1e-5)
            continue
        scale = np.abs(want).max()
        assert scale > 0, path
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * scale, err_msg=str(path))
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-3, atol=1e-5,
                                   err_msg=k)


def _scaled(agent):
    """A copy of a per-UE agent with every discrete head's last layer
    scaled, so no two logits tie to within float32 noise."""
    agent = jax.tree_util.tree_map(lambda x: x, agent)
    for name, layers in agent["actors"]["heads"].items():
        if name != "power":
            layers[-1] = {k: x * SCALE for k, x in layers[-1].items()}
    return agent


@functools.lru_cache(maxsize=None)
def _jax_trained():
    jv, _ = _quickstart_envs()
    agent, hist = jmahppo.train_mahppo(jv, jmahppo.MAHPPOConfig(iterations=2, **CFG), seed=0)
    return _scaled(agent), hist


def test_jax_trained_agent_acts_the_same():
    """A reference agent trained for two iterations (horizon 64, 2 envs),
    carried into the port: 16 deterministic eval frames take the same
    actions in both packages, every frame, and t_task / e_task agree to
    1e-5. The smallest top-2 logit margin is checked to be above 1e-3 and
    ten times the largest logit difference between the packages (the
    scaled logits differ by float32 rounding times the scale)."""
    jv, v = _quickstart_envs()
    jagent, hist = _jax_trained()
    assert len(hist) == 2
    agent = weights.agent_from_jax(_np_tree(jagent), "cpu")
    space = jv.action_space

    @jax.jit
    def frame(s):
        masks = jv.action_masks(s)
        dist = jmahppo._policy_all(jagent["actors"], space, jv.observe(s), masks)
        actions = jax.vmap(space.mode)(dist, masks)
        return jv.step(s, space.execute(actions))[0], dist, actions

    want = jmahppo.evaluate_policy(jv, jagent, frames=16)
    assert want["done"] == 0.0            # no auto-reset, whose draws differ
    trace = []
    got = mahppo.evaluate_policy(v, agent, frames=16, trace=trace)
    s = jv.reset(jax.random.PRNGKey(0), eval_mode=True)
    margin, err = np.inf, 0.0
    for fr in trace:
        s, jdist, jact = frame(s)
        for k, a in fr["actions"].items():
            if k == "power":
                np.testing.assert_allclose(a.numpy(), np.asarray(jact[k]), rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(jact[k]), err_msg=k)
        for h in v.action_space.discrete:
            top = torch.topk(fr["dist"][h.name], 2, dim=-1).values
            margin = min(margin, float((top[..., 0] - top[..., 1]).min()))
            err = max(err, float(np.abs(fr["dist"][h.name].numpy() - jdist[h.name]).max()))
    assert margin > max(1e-3, 10 * err)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_local_policy_eval_agrees():
    """Full-local on the quickstart env: every summary to 1e-5 over 16
    frames (no episode ends); over the example's 64 frames an episode ends
    and its auto-reset draws differ, so there only the per-task overheads,
    which do not depend on the draws."""
    jv, v = _quickstart_envs()
    for frames, keys in ((16, ("reward", "t_task", "e_task", "completed")),
                         (64, ("t_task", "e_task"))):
        want = jbaselines.local_policy_eval(jv, frames=frames)
        got = baselines.local_policy_eval(v, frames=frames)
        assert set(got) == set(want)
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_quickstart_twin_runs_on_the_cpu_when_asked(monkeypatch, capsys):
    out = quickstart.main(["--device", "cpu", "--iterations", "2", "--horizon", "64"])
    hist = out["history"]
    _, jhist = _jax_trained()
    assert len(hist) == 2 and set(hist[0]) == set(jhist[0])
    assert all(np.isfinite(r["reward_mean"]) for r in hist)
    assert [r["env_steps"] for r in hist] == [64, 128]
    assert set(out["mahppo"]) >= {"t_task", "e_task", "reward"}
    assert set(out["local"]) == {"reward", "t_task", "e_task", "completed"}
    assert "overhead reduction" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main(["--iterations", "1"])


def test_config_matches_reference_and_refuses_what_waits():
    assert [(f.name, f.default) for f in dataclasses.fields(mahppo.MAHPPOConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jmahppo.MAHPPOConfig)]
    for bad in (dict(horizon=100, n_envs=8), dict(n_shards=0), dict(n_envs=3, n_shards=2),
                dict(fused_scorer=True), dict(randomize_pool=True),
                dict(shared_policy=True, entity_policy=True)):
        with pytest.raises(ValueError):
            mahppo.MAHPPOConfig(**bad)
    _, v = _envs(3)
    # sharded rollouts need their ranks (tests/test_torch_sharding.py runs them)
    with pytest.raises(ValueError, match="n_shards=2"):
        mahppo.make_train_fns(v, mahppo.MAHPPOConfig(n_shards=2))
    # training through the fused scorer is ported; resampled geometry needs
    # an env built with pool_ranges, as in the reference
    mahppo.make_train_fns(v, mahppo.MAHPPOConfig(entity_policy=True, fused_scorer=True))
    with pytest.raises(ValueError, match="pool_ranges"):
        mahppo.init_states(v, mahppo.MAHPPOConfig(entity_policy=True, randomize_pool=True),
                           torch.Generator())
