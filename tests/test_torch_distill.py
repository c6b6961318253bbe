"""Parity of the port's distillation (``repro_torch.rl.distill``) with the
JAX reference, and the port's distillation pipeline at a test size.

The loss and its gradients are held to ``jax.value_and_grad`` of the
reference's loss (``distill_entity_policy``'s ``loss_fn``, a closure
there, written out below as the reference writes it) on the same rows,
labels and student, within 1e-4 of each leaf's largest gradient: both
sides sum the same float32 terms (M states x S draws x N UEs a head) in
different orders, and a leaf's small entries are differences of such
sums. One AdamW round is held to the reference's on the same gradients.

The pipeline (a port-trained teacher at the reference test's budget ->
DAgger distillation -> int8) is gated as the reference's own test gates
it: mode agreement at least 0.9, or the int8 student's evaluated overhead
within 1.05 x the teacher's. At that budget the teacher's heads are near
uniform, so its modes are argmax of noise that 4 Monte-Carlo labels a
state cannot convey (held-out agreement 0.05 on this fleet; the
reference's own run reaches 0.20 and passes by the overhead branch only
because its teacher scores 6.6 against its student's 0.32). The teacher's
heads' and scorer's last layers are therefore scaled by 100 after
training (as ``test_torch_policy`` scales its agents), which keeps every
mode and makes it a decision: the gate's strict branch then measures
whether distillation reproduces it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.rl import distill as jdistill
from repro.rl import nets as jnets
from repro_torch import weights
from repro_torch.core import fleets
from repro_torch.env import mecenv
from repro_torch.launch import fleet_demo
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.rl import distill, nets
from repro_torch.rl.mahppo import MAHPPOConfig, evaluate_policy, train_mahppo
from repro_torch.stream.adapter import TrunkDispatcher
from repro_torch.stream.events import StreamParams, StreamSim

from test_torch_stream import _envs

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

M, S = 24, 4
TEACHER_SCALE = 100.0
CFG = distill.DistillConfig(iterations=2, frames=32, n_envs=4, label_samples=4, epochs=100)


def _pool_env(n_ue=6, **kw):
    return mecenv.MECEnv(mecenv.make_env_params(fleets.make_mixed_fleet(n_ue=n_ue),
                                                n_channels=2, pool=fleets.make_edge_pool(2),
                                                device="cpu", **kw))


def _reference_loss(jenv, student, rows, labels):
    """The reference's distillation loss as ``distill_entity_policy``
    defines it."""
    space = jenv.action_space
    masks0 = jdistill._const_masks(jenv)

    def loss_fn(p, rows, labels):
        def one(r, lab):
            dist = jnets.flat_trunk_forward(p, space, r, masks0)
            lp = jax.vmap(lambda l: jax.vmap(space.log_prob)(dist, l))(lab)
            return lp.mean()

        return -jax.vmap(one)(rows, labels).mean()

    return jax.jit(jax.value_and_grad(loss_fn))(student, rows, labels)


def _rows_labels(space, n_ue, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((M, n_ue, 19)).astype(np.float32)
    labels = {h.name: rng.integers(0, h.n, (M, S, n_ue)).astype(np.int32)
              for h in space.discrete}
    labels.update({h.name: (2 * rng.standard_normal((M, S, n_ue))).astype(np.float32)
                   for h in space.continuous})
    return rows, labels


def test_loss_gradients_and_adamw_match_reference():
    jv, v = _envs(2)
    assert v.params.feasible.all()          # labels may take every choice
    jstudent = jnets.init_flat_trunk(jax.random.PRNGKey(3), jv.ue_feat_dim, jv.action_space)
    rows, labels = _rows_labels(v.action_space, v.params.n_ue)
    want, jgrads = _reference_loss(jv, jstudent, jnp.asarray(rows),
                                   {k: jnp.asarray(x) for k, x in labels.items()})
    student = weights.flat_trunk_from_jax(jax.tree_util.tree_map(np.asarray, jstudent), "cpu")
    params = list(student.parameters())
    masks = distill._const_masks(v)
    loss = distill.distill_loss(student, v.action_space, torch.from_numpy(rows),
                                {k: torch.from_numpy(x) for k, x in labels.items()}, masks)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    grads = torch.autograd.grad(loss, params)
    jleaves = [leaf for layer in jgrads["layers"] for leaf in (layer["w"], layer["b"])]
    for g, w in zip(grads, jleaves):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()
    # one AdamW round on the same gradients
    jnew, _ = jadamw_update(jgrads, jadamw_init(jstudent), jstudent, CFG.lr, weight_decay=0.0)
    adamw_update([torch.tensor(np.asarray(w)) for w in jleaves], adamw_init(params),
                 params, CFG.lr, weight_decay=0.0)
    for p, w in zip(params, [leaf for layer in jnew["layers"] for leaf in (layer["w"],
                                                                           layer["b"])]):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def pipeline():
    """Teacher -> student -> int8 at the reference test's sizes."""
    env = _pool_env()
    teacher, _ = train_mahppo(env, MAHPPOConfig(iterations=8, horizon=256, n_envs=4, reuse=4,
                                                entity_policy=True, lr=3e-4), seed=0)
    actor = teacher["entity_actor"]
    with torch.no_grad():
        for mlp in list(actor.heads.values()) + [actor.scorer]:
            mlp.layers[-1].w.mul_(TEACHER_SCALE)
            mlp.layers[-1].b.mul_(TEACHER_SCALE)
    student, hist = distill.distill_entity_policy(env, teacher, CFG, seed=0)
    return env, teacher, student, distill.quantize_flat_trunk(student), hist


def _overhead(env, agent):
    ev = evaluate_policy(env, agent, frames=32)
    return ev["t_task"] + env.params.beta * ev["e_task"]


def test_student_matches_teacher(pipeline):
    env, teacher, student, qstudent, hist = pipeline
    agree = distill.action_agreement(env, teacher, student, states=256, seed=42)
    ratio = _overhead(env, {"flat_trunk": qstudent}) / _overhead(env, teacher)
    assert agree["all"] >= 0.9 or ratio <= 1.05, (agree, ratio)
    assert agree["all"] >= 0.9, agree        # the strict branch, for a teacher that decides
    assert set(agree) == {"split", "channel", "route", "all", "power_gap"}
    power = env.action_space.head("power")
    assert agree["power_gap"] < 0.1 * (power.high - power.low)
    # the DAgger dataset grows by E * T states a round
    assert [h["states"] for h in hist] == [CFG.n_envs * CFG.frames * (it + 1)
                                           for it in range(CFG.iterations)]
    assert all(np.isfinite(h["loss"]) and 0.0 <= h["agreement"] <= 1.0 for h in hist)
    assert nets.param_count(student) <= 0.25 * nets.param_count(teacher["entity_actor"])
    assert nets.param_bytes(qstudent) < 0.5 * nets.param_bytes(student)


def test_trunk_dispatcher_masks_bind(pipeline):
    """On a copy of the env with splits forbidden, the int8 trunk's
    stream decisions stay feasible: only the dispatch-time masks can keep
    them so."""
    env, _, _, qstudent, _ = pipeline
    feas = env.params.feasible.clone()
    feas[::2, 0] = False
    feas[1::2, 1:3] = False
    renv = mecenv.MECEnv(env.params._replace(feasible=feas))
    disp = TrunkDispatcher(renv, qstudent, seed=0)
    calls = []

    def recording(core, ue):
        a = disp(core, ue)
        calls.append((ue, a))
        return a

    rep = StreamSim(renv, recording, StreamParams(rate=6.0, horizon=2.0), seed=3).run()
    assert rep["completed"] > 0 and calls
    for ue, a in calls:
        assert bool(feas[ue, a["split"]]) and 0 <= a["route"] < renv.n_servers


def test_distill_refuses_a_non_entity_teacher_and_a_dynamic_env():
    with pytest.raises(ValueError, match="entity"):
        distill.distill_entity_policy(_pool_env(n_ue=4), {"actors": None})
    env = _pool_env(n_ue=4, churn_rate=0.1)
    assert env.dynamic
    with pytest.raises(ValueError, match="dynamic"):
        distill.distill_entity_policy(env, {"entity_actor": None})


def test_fleet_demo_distill_runs_on_the_cpu(capsys):
    out = fleet_demo.main(["--device", "cpu", "--iterations", "1", "--distill"])
    text = capsys.readouterr().out
    for line in ("distilling into the serve-small flat trunk", "round 1: dataset 384 states",
                 "int8 student overhead", "batch-1 dispatch forward (best of 20)",
                 "distilled int8"):
        assert line in text, line
    d = out["distill"]
    assert [h["states"] for h in d["history"]] == [192, 384]
    assert set(d["forward_us"]) == {"entity teacher", "distilled f32", "distilled int8"}
    assert all(np.isfinite(v) and v > 0 for v in d["forward_us"].values())
    assert np.isfinite(d["overhead"]["int8"] / d["overhead"]["teacher"])
    assert d["qstudent"]["bits"] == 8 and len(d["qstudent"]["qlayers"]) == 3
