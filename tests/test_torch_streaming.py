"""Parity of the port's streaming fine-tune (``repro_torch.rl.streaming``)
with the JAX reference, and its launcher on the CPU.

``label_raw`` is held bit for bit to the reference's (a closure inside
``finetune_streaming``, rebuilt here from its code object over the
reference env's action space). ``_episode_logp`` and its gradient are
held to the reference's on decisions a reference ``_DaggerDispatcher``
recorded on a reference stream, carried into the port by
``weights.env_state_from_jax``: the reference stacks them padded to a
power of two with zero-weight rows, the port unpadded, so equal values and
gradients also show that the padding changes nothing. Values within 1e-5
relative and gradients within 1e-5 of each leaf's largest (float32 sums of
a few dozen decisions' log-probs through the same network).
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro.rl import mahppo as jmahppo
from repro.rl import streaming as jstreaming
from repro.stream import adapter as jadapter
from repro.stream import events as jevents
from repro_torch import weights
from repro_torch.launch import streaming_serve
from repro_torch.rl import streaming
from repro_torch.rl.mahppo import init_agent
from repro_torch.stream.events import StreamParams

from test_torch_stream import _envs

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers


def _reference_label_raw(jenv):
    """The reference's ``label_raw`` closure over ``jenv``'s space."""
    code = next(c for c in jstreaming.finetune_streaming.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "label_raw")
    cells = {"space": jenv.action_space, "n_ue": jenv.params.n_ue}
    return types.FunctionType(code, jstreaming.finetune_streaming.__globals__, "label_raw",
                              None, tuple(types.CellType(cells[n]) for n in code.co_freevars))


def test_label_raw_is_exact():
    jv, v = _envs(2)
    ref = _reference_label_raw(jv)
    p_max = v.params.p_max
    for lab in ({"split": 2, "channel": 1, "route": 1, "power": 0.98 * p_max},
                {"split": 5, "channel": 0, "route": 0, "power": 1e-4},      # clipped low
                {"split": 0, "channel": 1, "power": p_max},                 # clipped high
                {"split": 3, "channel": 0, "route": 1, "power": 0.25}):
        got = streaming.label_raw(v.action_space, v.params.n_ue, lab)
        want = ref(lab)
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].dtype == weights.action_from_jax({k: w}, "cpu")[k].dtype
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), err_msg=k)


def _leaf(tree, name):
    """The reference tree's leaf of a port parameter name
    (``heads.split.layers.1.w`` -> tree["heads"]["split"][1]["w"])."""
    for part in name.split("."):
        if part != "layers":
            tree = tree[int(part)] if part.isdigit() else tree[part]
    return np.asarray(tree)


def test_episode_logp_and_gradient_match_reference():
    jv, v = _envs(2)
    jagent = jax.jit(lambda k: jmahppo.init_agent(k, jv, entity_policy=True))(
        jax.random.PRNGKey(6))
    disp = jstreaming._DaggerDispatcher(jv, jagent, jadapter.StreamOracleDispatcher(jv),
                                        _reference_label_raw(jv), seed=1)
    jevents.StreamSim(jv, disp, jevents.StreamParams(rate=3.0, horizon=1.25), seed=2).run()
    n = len(disp.data)
    assert n > 8 and jstreaming._bucket(n) > n           # the reference pads this episode
    jst, jraw, jw = jstreaming._stack_decisions(jv, disp.data)
    actor = jagent["entity_actor"]
    want, jgrad = jax.jit(jax.value_and_grad(
        lambda p, st, raw, w: -jstreaming._episode_logp(jv, p, st, raw, w)))(
            actor, jst, jraw, jw / n)

    recs = [(weights.env_state_from_jax(s, "cpu"), weights.action_from_jax(lab, "cpu"), ue)
            for s, lab, ue in disp.data]
    st, raw, w = streaming._stack_decisions(v, recs)
    assert w.shape == (n, v.params.n_ue) and float(w.sum()) == n
    port = weights.entity_actor_from_jax(jax.tree_util.tree_map(np.asarray, actor), "cpu")
    loss = -streaming._episode_logp(v, port, st, raw, w / n)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    names = [name for name, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()))
    jtree = jax.tree_util.tree_map(np.asarray, jgrad)
    largest = max(np.abs(_leaf(jtree, name)).max() for name in names)
    for name, g in zip(names, grads):
        ref = _leaf(jtree, name)
        assert g.shape == ref.shape, name
        if name == "scorer.layers.1.b":
            # the route logits' common shift: a zero gradient in exact
            # arithmetic (both softmaxes ignore it), float noise on each side
            assert max(np.abs(g.numpy()).max(), np.abs(ref).max()) <= 1e-6 * largest
        else:
            assert np.abs(g.numpy() - ref).max() <= 1e-5 * np.abs(ref).max(), name


def test_finetune_streaming_smoke():
    """The reference's smoke assertions, on the port."""
    _, v = _envs(2)
    agent = init_agent(torch.Generator().manual_seed(0), v, entity_policy=True)
    before = {k: [p.detach().clone() for p in m.parameters()] for k, m in agent.items()}
    tuned, hist = streaming.finetune_streaming(
        v, agent, StreamParams(rate=3.0, horizon=1.5),
        streaming.StreamTuneConfig(iterations=2, episodes_per_iter=2), seed=0)
    assert len(hist) == 2
    assert all(np.isfinite(h["reward_mean"]) for h in hist)
    assert all(h["actor_delta"] > 0 for h in hist)
    assert not any(torch.isnan(p).any() for p in tuned["entity_actor"].parameters())
    assert tuned["critic"] is agent["critic"]
    # the critic rides along untouched, and the caller's actor is not trained in place
    for k, m in agent.items():
        assert all(torch.equal(p, q) for p, q in zip(m.parameters(), before[k])), k


def test_streaming_serve_runs_on_the_cpu(capsys):
    out = streaming_serve.main(["--device", "cpu", "--iters", "1", "--tune-iters", "1",
                                "--horizon", "2"])
    text = capsys.readouterr().out
    for line in ("training the entity policy: 1 MAHPPO iterations",
                 "streaming fine-tune: 1 DAgger iterations", "iter  0: reward=",
                 "streaming 2s of Poisson arrivals at 8 tasks/s/UE", "server task counts"):
        assert line in text, line
    names = ["entity (tuned)", "entity zero-shot", "nearest-server", "full-local"]
    assert list(out["reports"]) == names
    for name in names:
        assert f"  {name:16s} throughput=" in text
        rep, led = out["reports"][name], out["cores"][name].ledger()
        assert rep["tasks"] == rep["arrivals"] == led["arrivals"] > 0
        assert led["completed"] + led["dropped"] == led["arrivals"]
        assert 0.0 <= rep["miss_rate"] <= 1.0
    # every dispatcher streams the same arrivals
    assert len({out["reports"][k]["arrivals"] for k in names}) == 1
    assert sum(out["per_server"]) == out["reports"]["entity (tuned)"]["completed"]
    assert len(out["tune_history"]) == 1 and out["env"].params.n_ue == 8


def test_streaming_serve_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming_serve.main(["--iters", "1", "--tune-iters", "0"])
