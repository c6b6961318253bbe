"""The measured split tables and batched policy evaluation of the port,
against the JAX reference.

Measured tables: ``core.split.measured_cnn_module_costs`` counts each CNN
module's run (``launch.opcount``) where the reference reads XLA's cost
analysis of the compiled module, so the two packages' costs differ by
design (no fusion here, elementwise FLOPs not counted). The table's
arithmetic is held to the reference's by feeding both the same module
costs, rate-distortion rows and AE ratios: field for field, to float64
round-off. The counts themselves are held to the reference's band against
the walker's ``module_flops`` (``tests/test_split_measured.py``), and are
the same on ``meta`` and on real CPU tensors.

Batched evaluation: ``evaluate_policy(n_envs=E)`` runs E eval episodes
as one batched state. The two packages draw different random streams, so
parity with the reference is its aggregate formula (``src/repro/rl/
mahppo.py:505-509``) applied to E single-env traces that the batched run
must reproduce env by env, as the reference's own
``test_sharded_eval_matches_unsharded`` argues for its shards: each env's
draws (auto-resets and churn) are injected as a function of the env and
the call, so env i gets the same variates alone and in the batch.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import cnn as jcnn
from repro.core import overhead as joh
from repro.core import split as jsplit
from repro.configs import get_config as jget_config
from repro_torch.configs import get_config
from repro_torch.core import cnn, fleets, overhead as oh, split
from repro_torch.env import mecenv
from repro_torch.rl import mahppo, nets
from repro_torch.rl.distill import quantize_flat_trunk

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

IN_SIZE = 32
TABLE_FIELDS = ("t_local", "e_local", "t_comp", "e_comp", "f_bits", "feasible")


@functools.lru_cache(maxsize=None)
def _tiny():
    """``tests/test_split_measured.py``'s CNN: ResNet18 at width 0.25, 10
    classes, and its counted module costs at 32 px (meta)."""
    model = cnn.make_resnet18(10, width=0.25)
    return model, split.measured_cnn_module_costs(model, IN_SIZE)


def _rd_rows(model):
    """Rate-distortion rows as ``measure_rate_distortion`` gives them."""
    shapes = model.feature_shapes(IN_SIZE)
    return [{"ch_prime": max(1, shapes[k][0] // r), "bits": b}
            for k, r, b in zip(model.split_after, (8, 4, 3, 2), (8, 6, 4, 8))]


@pytest.mark.parametrize("case", ["paper_ratios", "scalar_ratio", "rd_rows", "batch2_nano"])
def test_measured_table_matches_reference_given_same_costs(case):
    model, costs = _tiny()
    jmodel = jcnn.make_resnet18(10, width=0.25)
    kw, jkw = {}, {}
    if case == "scalar_ratio":
        kw = jkw = {"ae_ratio": 6, "quant_bits": 6}
    elif case == "rd_rows":
        kw = jkw = {"rd": _rd_rows(model)}
    elif case == "batch2_nano":
        kw, jkw = ({"batch": 2, "dev": oh.JETSON_NANO, "input_bits_per_px": 10},
                   {"batch": 2, "dev": joh.JETSON_NANO, "input_bits_per_px": 10})
    got = split.measured_cnn_split_table(model, IN_SIZE, module_costs=costs, **kw)
    want = jsplit.measured_cnn_split_table(jmodel, IN_SIZE, module_costs=costs, **jkw)
    assert got.name == want.name and got.points == list(want.points)
    assert got.device == want.device
    for f in TABLE_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(got, f), np.float64),
                                   np.asarray(getattr(want, f), np.float64),
                                   rtol=1e-12, atol=0, err_msg=f)


def test_counted_flops_sit_in_the_reference_band_of_the_walker():
    """The reference's own band (``test_split_measured.py``): the counted
    FLOPs sum to 0.25-4x the hand-derived walker's; every module's counts
    are positive, and only the head runs a product (the convolutions are
    not products)."""
    model, costs = _tiny()
    walker = float(sum(model.module_flops(IN_SIZE)))
    total = sum(c["flops"] for c in costs)
    assert 0.25 * walker < total < 4 * walker, (total, walker)
    assert len(costs) == model.n_modules
    for c in costs:
        assert c["flops"] > 0 and c["bytes_accessed"] > 0
    assert [c["dot_flops"] > 0 for c in costs] == [False] * (model.n_modules - 1) + [True]


def test_counts_are_the_same_on_meta_and_on_cpu_tensors():
    model, costs = _tiny()
    assert split.measured_cnn_module_costs(model, IN_SIZE, device="cpu") == costs


def test_table_counts_its_own_costs_and_checks_rd():
    model, costs = _tiny()
    own = split.measured_cnn_split_table(model, IN_SIZE)
    given = split.measured_cnn_split_table(model, IN_SIZE, module_costs=costs)
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(own, f), getattr(given, f))
    assert own.name == "resnet18-measured" and own.feasible.all()
    assert own.f_bits[0] == 3 * IN_SIZE * IN_SIZE * 8 and own.f_bits[-1] == 0
    with pytest.raises(ValueError, match="rows for"):
        split.measured_cnn_split_table(model, IN_SIZE, module_costs=costs,
                                       rd=_rd_rows(model)[:3])


def test_measured_split_table_dispatches_like_the_reference():
    model, costs = _tiny()
    cfg = get_config("qwen3-1.7b")
    got = split.measured_split_table(cfg, ctx_len=512, gen_tokens=8, kv_bits=8)
    same = split.llm_decode_split_table(cfg, 512, gen_tokens=8, kv_bits=8)
    want = jsplit.measured_split_table(jget_config("qwen3-1.7b"), ctx_len=512, gen_tokens=8,
                                       kv_bits=8)
    assert got.name == same.name == want.name
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(same, f))
        np.testing.assert_allclose(np.asarray(getattr(got, f), np.float64),
                                   np.asarray(getattr(want, f), np.float64), rtol=1e-6,
                                   err_msg=f)
    cnn_plan = split.measured_split_table(model, in_size=IN_SIZE, module_costs=costs)
    np.testing.assert_array_equal(
        cnn_plan.t_local,
        split.measured_cnn_split_table(model, IN_SIZE, module_costs=costs).t_local)


# ------------------------------------------------------ batched evaluation
N_UE, N_ENVS, FRAMES, LAM = 8, 4, 12, 3.0


@functools.lru_cache(maxsize=None)
def _plan():
    return split.cnn_split_table(cnn.make_resnet18(101), 224)


def _env(churn):
    """ResNet18's table for N = 8 UEs on the 3-server pool, 3 tasks a UE
    (episodes end within the run, so the auto-resets' draws matter),
    churned or static."""
    rates = dict(churn_rate=0.3, leave_rate=0.2) if churn else {}
    return mecenv.MECEnv(mecenv.make_env_params(
        _plan(), n_ue=N_UE, n_channels=2, t0=0.5, beta=0.47, lam_tasks=LAM,
        pool=fleets.make_edge_pool(3), device="cpu", **rates))


def _inject(monkeypatch, env, env_index=None):
    """Draw call c's variates for every env from ``default_rng([7, c])``;
    a single-env run (``env_index``) takes its env's row."""
    prm, calls = env.params, {"tasks": 0, "churn": 0}

    def pick(a, shape):
        return torch.from_numpy(a if env_index is None else a[env_index]).reshape(shape)

    def tasks(gen, shape):
        rng = np.random.default_rng([7, calls["tasks"]])
        calls["tasks"] += 1
        k = rng.poisson(prm.lam_tasks, (N_ENVS, N_UE)).astype(np.float32)
        d = rng.uniform(prm.d_low, prm.d_high, (N_ENVS, N_UE)).astype(np.float32)
        return pick(k, shape), pick(d, shape)

    def churn(gen, shape):
        rng = np.random.default_rng([8, calls["churn"]])
        calls["churn"] += 1
        u = rng.random((2, N_ENVS, N_UE)).astype(np.float32)
        return (pick(u[0], shape), pick(u[1], shape)) + tasks(gen, shape)

    monkeypatch.setattr(env, "_draw_tasks", tasks)
    monkeypatch.setattr(env, "_draw_churn", churn)


def _agent(env, kind):
    gen = torch.Generator().manual_seed(11)
    if kind in ("per_ue", "shared", "entity", "entity_fused"):
        agent = mahppo.init_agent(gen, env, shared_policy=kind == "shared",
                                  entity_policy=kind.startswith("entity"))
        return {k: v for k, v in agent.items() if k != "critic"}
    trunk = nets.init_flat_trunk(gen, env.ue_feat_dim, env.action_space)
    return {"flat_trunk": quantize_flat_trunk(trunk) if kind == "int8_trunk" else trunk}


def _runs(monkeypatch, kind, churn):
    env = _env(churn)
    agent = _agent(env, kind)
    fused = kind == "entity_fused"
    _inject(monkeypatch, env)
    batched = []
    got = mahppo.evaluate_policy(env, agent, frames=FRAMES, fused_scorer=fused, n_envs=N_ENVS,
                                 trace=batched)
    singles = []
    for i in range(N_ENVS):
        _inject(monkeypatch, env, i)
        trace = []
        mahppo.evaluate_policy(env, agent, frames=FRAMES, fused_scorer=fused, trace=trace)
        singles.append(trace)
    return got, batched, singles


def _reference_aggregate(singles):
    """The reference's summary of a batched eval (``mahppo.py:505-509``):
    each field's mean over envs and frames; t_task and e_task the means of
    t_sum and e_sum over max(mean(w_sum), 1e-9)."""
    out = {k: np.array([[float(fr[k]) for fr in tr] for tr in singles], np.float64)
           for k in mahppo._SUMMARY}
    res = {k: float(v.mean()) for k, v in out.items()}
    res["t_task"] = res.pop("t_sum") / max(res["w_sum"], 1e-9)
    res["e_task"] = res.pop("e_sum") / max(res.pop("w_sum"), 1e-9)
    return res


def _dist_close(got, want, tol=1e-5):
    for name, w in want.items():
        pairs = [(got[name][k], w[k]) for k in ("mu", "log_std")] if isinstance(w, dict) \
            else [(got[name], w)]
        for g, v in pairs:
            np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("kind,churn", [("per_ue", False), ("shared", False),
                                        ("entity", False), ("entity_fused", False),
                                        ("f32_trunk", False), ("int8_trunk", False),
                                        ("entity_fused", True), ("shared", True)])
def test_batched_eval_is_the_reference_aggregate_of_single_env_traces(monkeypatch, kind, churn):
    got, batched, singles = _runs(monkeypatch, kind, churn)
    assert len(batched) == FRAMES
    for f, fr in enumerate(batched):
        assert fr["reward"].shape == (N_ENVS,)
        for i, tr in enumerate(singles):
            one = tr[f]
            for k in mahppo._SUMMARY:
                np.testing.assert_allclose(float(fr[k][i]), float(one[k]), rtol=1e-5,
                                           atol=1e-6, err_msg=f"frame {f} env {i} {k}")
            for head, a in one["actions"].items():
                if head == "power":
                    np.testing.assert_allclose(fr["actions"][head][i].numpy(), a.numpy(),
                                               rtol=1e-5, atol=1e-6)
                else:
                    np.testing.assert_array_equal(fr["actions"][head][i].numpy(), a.numpy(),
                                                  err_msg=f"frame {f} env {i} {head}")
            _dist_close({h: ({k: v[i] for k, v in d.items()} if isinstance(d, dict) else d[i])
                         for h, d in fr["dist"].items()}, one["dist"])
            np.testing.assert_array_equal(fr["active"][i].numpy(), one["active"].numpy())
    want = _reference_aggregate(singles)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    # the episodes end and auto-reset inside the run, so the envs' traces part
    done = np.array([[float(fr["done"]) for fr in tr] for tr in singles])
    assert done.any()
    rewards = np.array([[float(fr["reward"]) for fr in tr] for tr in singles])
    assert not np.allclose(rewards, rewards[:1])
    if churn:
        members = {tuple(fr["active"].reshape(-1).tolist()) for fr in batched}
        assert len(members) > 1


def test_batched_fused_eval_scores_all_envs_in_one_call_a_frame(monkeypatch):
    """The entity agent through ``ops.pair_scorer``: one call a frame for
    all envs, with the env axis on its inputs (on the card, one launch)."""
    from repro_torch.kernels import ops
    env = _env(False)
    calls = []
    real = ops.pair_scorer

    def spy(ue_emb, raw, srv_enc, scorer):
        calls.append(tuple(ue_emb.shape))
        return real(ue_emb, raw, srv_enc, scorer)

    monkeypatch.setattr(ops, "pair_scorer", spy)
    mahppo.evaluate_policy(env, _agent(env, "entity_fused"), frames=5, fused_scorer=True,
                           n_envs=N_ENVS)
    assert len(calls) == 5 and all(c[:2] == (N_ENVS, N_UE) for c in calls)


def test_batched_eval_refuses_what_waits():
    env = _env(False)
    agent = _agent(env, "f32_trunk")
    with pytest.raises(ValueError, match="divisible"):
        mahppo.evaluate_policy(env, agent, frames=1, n_envs=3, n_shards=2)
    # sharded evaluation needs its ranks (tests/test_torch_sharding.py runs them)
    with pytest.raises(ValueError, match="launch 2 ranks"):
        mahppo.evaluate_policy(env, agent, frames=1, n_envs=4, n_shards=2)
