"""Parity of the port's action space, policy nets, trunk quantization and
``evaluate_policy`` with the JAX reference, weights carried across by
``repro_torch.weights``.

The slice as a whole: the entity agent through the fused pair scorer and
the int8 flat trunk each schedule the slice's mixed fleet (N = 16, the
3-server pool) for 16 eval frames on both sides. The reference runs as it
runs on the CPU (the kernels' decomposed XLA forms); the port runs its
kernels' plain twins. Random init leaves logits near 0.01, where two
choices can tie to within float32 noise, so the last layer of every head
and of the scorer is scaled by the same factor on both sides and the
smallest top-2 margin is checked to be above 1e-3: an action that then
differs is a fault, not noise.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl import distill as jdistill
from repro.rl import mahppo as jmahppo
from repro.rl import nets as jnets
from repro_torch import weights
from repro_torch.rl import distill, mahppo, nets

from test_torch_env import _envs, _jstate, _states, _tstate

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

N, FRAMES, SCALE = 16, 16, 300.0


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _dist_close(got, want, tol=1e-5):
    for name, w in want.items():
        if isinstance(w, dict):
            for k in ("mu", "log_std"):
                np.testing.assert_allclose(got[name][k].numpy(), np.asarray(w[k]),
                                           rtol=tol, atol=tol, err_msg=f"{name}.{k}")
        else:
            np.testing.assert_allclose(got[name].numpy(), np.asarray(w), rtol=tol, atol=tol,
                                       err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_entity():
    """One JAX entity agent for the file (jitted: the eager init takes
    twice as long)."""
    jv, _ = _envs(3)
    return jax.jit(lambda k: jmahppo.init_agent(k, jv, entity_policy=True))(
        jax.random.PRNGKey(2))


def _entity(scale=1.0):
    """A copy of the JAX entity agent with its heads' and scorer's last
    layers scaled, and its numpy tree."""
    agent = jax.tree_util.tree_map(lambda x: x, _jax_entity())
    actor = agent["entity_actor"]
    for layers in list(actor["heads"].values()) + [actor["scorer"]]:
        layers[-1] = {k: v * scale for k, v in layers[-1].items()}
    return agent, _np_tree(agent)


def _trunk(seed, scale=1.0):
    jv, _ = _envs(3)
    p = jnets.init_flat_trunk(jax.random.PRNGKey(seed), jv.ue_feat_dim, jv.action_space)
    p["layers"][-1] = {k: v * scale for k, v in p["layers"][-1].items()}
    return p


@torch.no_grad()
def test_actionspace_agrees():
    jv, v = _envs(3)
    jspace, space = jv.action_space, v.action_space
    assert space.names == jspace.names == ("split", "channel", "route", "power")
    rng = np.random.default_rng(0)
    split_mask = rng.random((N, 6)) < 0.7
    split_mask[:, -1] = True                     # full-local always feasible
    jm = jspace.broadcast_masks({"split": jnp.asarray(split_mask)}, N)
    m = space.broadcast_masks({"split": torch.from_numpy(split_mask)}, N)
    assert set(m) == set(jm) == {"split", "channel", "route"}
    for k in m:
        np.testing.assert_array_equal(m[k].numpy(), np.asarray(jm[k]))
    _, tree = _entity(SCALE)
    heads = {k: v for k, v in tree["entity_actor"]["heads"].items()}
    port_heads = weights.entity_actor_from_jax(tree["entity_actor"], "cpu").heads
    h = rng.standard_normal((N, 160)).astype(np.float32)
    route = rng.standard_normal((N, 3)).astype(np.float32)
    jdist = jax.vmap(lambda hh, rl, mm: jspace.forward(heads, hh, jnets._mlp, mm,
                                                       provided={"route": rl}))(
        jnp.asarray(h), jnp.asarray(route), jm)
    dist = space.forward(port_heads, torch.from_numpy(h), m,
                         provided={"route": torch.from_numpy(route)})
    _dist_close(dist, jdist)
    assert (dist["split"][~m["split"]] == -1e9).all()
    jmode, mode = jax.vmap(jspace.mode)(jdist, jm), space.mode(dist, m)
    for k in ("split", "channel", "route"):
        np.testing.assert_array_equal(mode[k].numpy(), np.asarray(jmode[k]))
    np.testing.assert_allclose(mode["power"].numpy(), np.asarray(jmode["power"]), rtol=1e-5,
                               atol=1e-5)
    assert all(bool(m["split"][i, mode["split"][i]]) for i in range(N))
    raw = {"split": mode["split"], "channel": mode["channel"], "route": mode["route"],
           "power": torch.from_numpy(rng.standard_normal(N).astype(np.float32) * 3)}
    jraw = {k: jnp.asarray(t.numpy()) for k, t in raw.items()}
    phys, jphys = space.execute(raw), jspace.execute(jraw)
    np.testing.assert_allclose(phys["power"].numpy(), np.asarray(jphys["power"]), rtol=1e-6)
    over = {**phys, "power": phys["power"] * 2 - 0.3}
    np.testing.assert_array_equal(
        space.clip(over)["power"].numpy(),
        np.asarray(jspace.clip({k: jnp.asarray(t.numpy()) for k, t in over.items()})["power"]))
    lp = space.log_prob(dist, raw)
    jlp = jax.vmap(jspace.log_prob)(jdist, jraw)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(space.entropy(dist).numpy(),
                               np.asarray(jax.vmap(jspace.entropy)(jdist)), rtol=1e-5)
    # sampling from flat logits (the mask applied by sample itself):
    # masked choices are never drawn, every open one is
    gen = torch.Generator().manual_seed(3)
    flat = {h.name: torch.zeros(200 * N, h.n) for h in space.discrete}
    flat["power"] = {"mu": torch.zeros(200 * N), "log_std": torch.zeros(200 * N)}
    masks = {k: t.repeat(200, 1) for k, t in m.items()}
    draws = space.sample(gen, flat, masks)
    picked = torch.zeros_like(masks["split"]).scatter_(1, draws["split"][:, None], True)
    assert not (picked & ~masks["split"]).any()
    assert torch.equal(picked.reshape(200, N, 6).any(0), m["split"])


def test_entity_actor_and_critic_agree():
    jv, v = _envs(3)
    agent, tree = _entity()
    actor = weights.entity_actor_from_jax(tree["entity_actor"], "cpu")
    critic = weights.mlp_from_jax(tree["critic"], "cpu")
    assert nets.param_count(actor) == jnets.param_count(agent["entity_actor"]) == 67419
    assert nets.param_bytes(actor) == jnets.param_bytes(agent["entity_actor"])
    jspace, space = jv.action_space, v.action_space
    for seed in range(2):
        arrs = _states(seed)
        js, s = _jstate(arrs), _tstate(arrs)
        jm = jspace.broadcast_masks(jv.action_masks(js), N)
        m = space.broadcast_masks(v.action_masks(s), N)
        with torch.no_grad():
            for jobs, obs in ((jv.observe_entities(js), v.observe_entities(s)),
                              (jv.observe_entities_raw(js), v.observe_entities_raw(s))):
                _dist_close(nets.entity_actor_forward(actor, space, obs, m),
                            jnets.entity_actor_forward(agent["entity_actor"], jspace, jobs, jm))
                np.testing.assert_allclose(
                    float(nets.entity_value_forward(actor, critic, obs)),
                    float(jnets.entity_value_forward(agent["entity_actor"], agent["critic"],
                                                     jobs)), rtol=1e-5, atol=1e-6)


def test_flat_trunk_and_its_quantization_agree():
    jv, v = _envs(3)
    p = _trunk(4)
    trunk = weights.flat_trunk_from_jax(_np_tree(p), "cpu")
    assert nets.param_count(trunk) == jnets.param_count(p) == 6285
    assert nets.trunk_width(v.action_space) == jnets.trunk_width(jv.action_space) == 13
    jq = jdistill.quantize_flat_trunk(p)
    q = distill.quantize_flat_trunk(trunk)
    assert q["bits"] == jq["bits"] == 8
    for a, b in zip(q["qlayers"], jq["qlayers"]):
        np.testing.assert_array_equal(a["codes"].numpy(), np.asarray(b["codes"]))
        assert a["codes"].dtype == torch.uint8
        assert a["mn"] == np.asarray(b["mn"]) and a["mx"] == np.asarray(b["mx"])
        np.testing.assert_array_equal(a["b"].numpy(), np.asarray(b["b"]))
    assert nets.param_count(q) == jnets.param_count(jq)
    assert nets.param_bytes(q) == jnets.param_bytes(jq)
    carried = weights.flat_trunk_from_jax(_np_tree(jq), "cpu")
    arrs = _states(5)
    js, s = _jstate(arrs), _tstate(arrs)
    jm = jv.action_space.broadcast_masks(jv.action_masks(js), N)
    m = v.action_space.broadcast_masks(v.action_masks(s), N)
    feats, jfeats = v.observe_per_ue(s), jv.observe_per_ue(js)
    with torch.no_grad():
        for port, ref in ((trunk, p), (q, jq), (carried, jq)):
            _dist_close(nets.flat_trunk_forward(port, v.action_space, feats, m),
                        jnets.flat_trunk_forward(ref, jv.action_space, jfeats, jm))


def _jax_frames(jv, agent, fused):
    """The reference's eval rollout written out frame by frame (the body of
    ``evaluate_policy``'s scan), returning each frame's dist and actions."""
    space = jv.action_space
    entity = "entity_actor" in agent
    obs = jv.observe_entities_raw if fused else jv.observe_entities

    @jax.jit
    def frame(s):
        masks = space.broadcast_masks(jv.action_masks(s), N)
        if entity:
            dist = jnets.entity_actor_forward(agent["entity_actor"], space, obs(s), masks)
        else:
            dist = jnets.flat_trunk_forward(agent["flat_trunk"], space,
                                            jv.observe_per_ue(s), masks)
        actions = jax.vmap(space.mode)(dist, masks)
        s2, _, done, _ = jv.step(s, space.execute(actions))
        return s2, dist, actions, done

    s = jv.reset(jax.random.PRNGKey(0), eval_mode=True)
    out = []
    for _ in range(FRAMES):
        s, dist, actions, done = frame(s)
        assert not bool(done)
        out.append((dist, actions))
    return out


def _margin(trace):
    """Smallest top-2 logit margin over every discrete head, UE and frame."""
    least = np.inf
    for fr in trace:
        for name in ("split", "channel", "route"):
            top = torch.topk(fr["dist"][name], 2, dim=-1).values
            least = min(least, float((top[:, 0] - top[:, 1]).min()))
    return least


@pytest.mark.parametrize("agent_kind", ["entity_fused", "int8_trunk"])
def test_evaluate_policy_matches_jax(agent_kind):
    jv, v = _envs(3)
    if agent_kind == "entity_fused":
        jagent, tree = _entity(SCALE)
        agent = {"entity_actor": weights.entity_actor_from_jax(tree["entity_actor"], "cpu")}
        jagent = {"entity_actor": jagent["entity_actor"]}
    else:
        jq = jdistill.quantize_flat_trunk(_trunk(7, SCALE))
        jagent = {"flat_trunk": jq}
        agent = {"flat_trunk": weights.flat_trunk_from_jax(_np_tree(jq), "cpu")}
    fused = agent_kind == "entity_fused"
    want = jmahppo.evaluate_policy(jv, jagent, frames=FRAMES, fused_scorer=fused)
    assert want["done"] == 0.0            # no auto-reset, whose draws differ
    trace = []
    got = mahppo.evaluate_policy(v, agent, frames=FRAMES, fused_scorer=fused, trace=trace)
    assert len(trace) == FRAMES and _margin(trace) > 1e-3
    for (jdist, jact), fr in zip(_jax_frames(jv, jagent, fused), trace):
        for k, a in fr["actions"].items():
            if k == "power":
                np.testing.assert_allclose(a.numpy(), np.asarray(jact[k]), rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(jact[k]), err_msg=k)
        _dist_close(fr["dist"], jdist)
    assert set(got) == set(want) == {"reward", "completed", "n_active", "done", "t_task",
                                     "e_task"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert got["completed"] > 0


def test_evaluate_policy_refuses_what_waits():
    _, v = _envs(3)
    trunk = {"flat_trunk": nets.init_flat_trunk(torch.Generator().manual_seed(0), 19,
                                                v.action_space)}
    # sharded evaluation needs its ranks (tests/test_torch_sharding.py runs them)
    with pytest.raises(ValueError, match="launch 2 ranks"):
        mahppo.evaluate_policy(v, trunk, frames=1, n_envs=2, n_shards=2)
    with pytest.raises(ValueError, match="entity"):
        mahppo.evaluate_policy(v, trunk, frames=1, fused_scorer=True)
