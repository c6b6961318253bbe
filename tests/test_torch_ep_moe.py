"""Parity of the port's expert-parallel MoE paths with the JAX reference on
the CPU, over four gloo ranks.

The reference's ``apply_moe_ep`` and ``apply_moe_ep_decode`` run under
``shard_map`` in a subprocess with four forced host devices (as
``tests/test_ep_moe.py`` runs them), on a (2, 2) mesh over ("data",
"model") and a (2, 1, 2) mesh over ("pod", "data", "model"), at a
capacity factor where experts drop (0.5) and at 8.0; the same script
replays each data shard's routing in ``jnp`` (the kept assignments) and
records which path the reference's ``apply_moe`` picks for a set of
shapes. The port's ranks are spawned once (``launch.mesh.spawn``), build
both meshes, load the reference's ``init_moe`` draw sharded by
``weights.moe_from_jax`` and run the same calls on their shards of x; they
also serve a reduced qwen3-moe through ``serve(mesh=...)``, which the
test holds to a one-process serve. The config is the reference test's (d
32, 8 experts, top-2, d_expert 16, one shared expert, fsdp, f32).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ModelConfig, MoEConfig, get_config, reduced
from repro_torch.launch.mesh import Mesh, ProcessMesh, spawn
from repro_torch.launch.serve import serve
from repro_torch.models import meshctx, moe
from repro_torch.weights import moe_from_jax, shard_moe_params

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x2": (("data", "model"), (2, 2)), "2x1x2": (("pod", "data", "model"), (2, 1, 2))}
CFS = (0.5, 8.0)                 # experts drop at 0.5; nothing drops at 8.0
PATHS = ("ep", "ep_decode")
X_SHAPE = (4, 8, 32)
MIN_GAP = 1e-5                   # the least k-th / (k+1)-th router gap (see test_torch_moe)
# (name, n_experts, fsdp, batch, seq): apply_moe's choice around 4 096 global tokens, an
# indivisible batch, experts the model axis does not divide, and no fsdp
CHOICES = (("decode_4096", 8, True, 4, 1024), ("ep_4100", 8, True, 4, 1025),
           ("indivisible", 8, True, 3, 8), ("experts_7", 7, True, 4, 8),
           ("no_fsdp", 8, False, 4, 8))
SERVE_CFG = dict(batch=4, prompt_len=16, gen=4, requests=1)

_SCRIPT = r"""
import math, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.base import ModelConfig, MoEConfig
from repro.models import meshctx
from repro.models import moe as jmoe

MESHES = {"2x2": (("data", "model"), (2, 2)), "2x1x2": (("pod", "data", "model"), (2, 1, 2))}
CHOICES = %(choices)r

def cfg_of(cf, e=8, fsdp=True):
    return ModelConfig(
        name="t", family="moe", n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
        vocab_size=32, block_pattern=("moe",),
        moe=MoEConfig(n_experts=e, top_k=2, d_expert=16, capacity_factor=cf,
                      n_shared_experts=1),
        param_dtype="float32", compute_dtype="float32", fsdp=fsdp)

def routing(xs, router, k, cap):
    xf = xs.reshape(-1, xs.shape[-1])
    t = xf.shape[0]
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ router, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, k)
    e_flat = top_e.reshape(t * k)
    order = jnp.argsort(e_flat)
    e_sorted = e_flat[order]
    counts = jnp.zeros((router.shape[1],), jnp.int32).at[e_flat].add(1)
    offsets = jnp.cumsum(counts) - counts
    rank = jnp.arange(t * k, dtype=jnp.int32) - offsets[e_sorted]
    srt = jnp.sort(probs, axis=-1)[:, ::-1]
    gap = float(jnp.min(srt[:, k - 1] - srt[:, k]))
    return [np.asarray(a) for a in (e_sorted, rank, order // k, rank < cap)], gap

out = {}
cfg = cfg_of(8.0)
p = jmoe.init_moe(jax.random.PRNGKey(0), cfg)
x = jax.random.normal(jax.random.PRNGKey(1), %(x_shape)r) * 0.5
out["x"] = np.asarray(x)
for k_, v in p.items():
    out["p_" + k_] = np.asarray(v)
gaps = []
for name, (axes, sizes) in MESHES.items():
    mesh = jax.make_mesh(sizes, axes)
    dp = 2
    for cf in %(cfs)r:
        c = cfg_of(cf)
        with meshctx.use_mesh(mesh):
            for path, fn in (("ep", jmoe.apply_moe_ep), ("ep_decode", jmoe.apply_moe_ep_decode)):
                o, aux = jax.jit(lambda p, x: fn(p, x, c, mesh))(p, x)
                tag = f"{name}_{cf}_{path}"
                out[tag + "_out"], out[tag + "_aux"] = np.asarray(o), np.asarray(aux)
                b, s, d = x.shape
                k = c.moe.top_k
                if path == "ep":
                    cap = max(4, math.ceil(b * s // dp * k / c.moe.n_experts * cf))
                    shards = [x[i * b // dp:(i + 1) * b // dp] for i in range(dp)]
                else:
                    cap = max(4, math.ceil(b * s * k / c.moe.n_experts * cf))
                    shards = [x]
                for i, xs in enumerate(shards):
                    r, gap = routing(xs, p["router"], k, cap)
                    gaps.append(gap)
                    for f, a in zip(("expert", "rank", "token", "kept"), r):
                        out[f"{tag}_{i}_{f}"] = a
out["gap"] = np.float32(min(gaps))

# which path the reference's apply_moe takes, recorded by stand-ins
taken = []
jmoe.apply_moe_ep = lambda p, x, cfg, mesh: taken.append("ep") or (x, 0.0)
jmoe.apply_moe_ep_decode = lambda p, x, cfg, mesh: taken.append("ep_decode") or (x, 0.0)
jmoe._apply_moe_global = lambda p, x, cfg: taken.append("global") or (x, 0.0)
for name, (axes, sizes) in MESHES.items():
    mesh = jax.make_mesh(sizes, axes)
    for case, e, fsdp, b, s in CHOICES:
        with meshctx.use_mesh(mesh):
            jmoe.apply_moe(None, jnp.zeros((b, s, 32)), cfg_of(1.0, e, fsdp))
        out[f"choice_{name}_{case}"] = np.array(taken[-1])
np.savez(sys.argv[1], **out)
print("REF_OK")
"""


def cfg_of(cf, e=8, fsdp=True):
    return ModelConfig(
        name="t", family="moe", n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
        vocab_size=32, block_pattern=("moe",),
        moe=MoEConfig(n_experts=e, top_k=2, d_expert=16, capacity_factor=cf,
                      n_shared_experts=1),
        param_dtype="float32", compute_dtype="float32", fsdp=fsdp)


def serve_cfg():
    """Reduced qwen3-moe, 2 layers, fsdp on (so decode takes the decode
    path), at a capacity factor where nothing drops."""
    cfg = reduced(get_config("qwen3-moe-30b-a3b"), n_layers=2).replace(fsdp=True)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def _rank(rank, device, params, x):
    """Each mesh: the port's EP calls on this rank's shard of x, with their
    routings; then the reduced serve on the (2, 2) mesh."""
    meshes = {name: ProcessMesh(*spec) for name, spec in MESHES.items()}
    out = {"coords": {name: (m.index(meshctx.dp_axes(m)), m.index("model"))
                      for name, m in meshes.items()}}
    for name, mesh in meshes.items():
        b = x.shape[0] // meshctx.dp_size(mesh)
        i = mesh.index(meshctx.dp_axes(mesh))
        xl = torch.from_numpy(x[i * b:(i + 1) * b])
        for cf in CFS:
            cfg = cfg_of(cf)
            with meshctx.use_mesh(mesh), torch.no_grad():
                layer = moe_from_jax(params, cfg, device)
                out[f"{name}_{cf}_shapes"] = tuple(tuple(getattr(layer, k).shape)
                                                   for k in ("wi", "wo"))
                for path, fn in (("ep", moe.apply_moe_ep), ("ep_decode", moe.apply_moe_ep_decode)):
                    with moe.routing_log() as log:
                        o, aux = fn(layer, xl, cfg, mesh)
                    r = log.calls[0]
                    out[f"{name}_{cf}_{path}"] = (o, aux, {f: getattr(r, f).numpy() for f in
                                                           ("expert", "rank", "token", "kept")})
    res = serve(serve_cfg(), device=device, log=lambda *a: None, mesh=meshes["2x2"], **SERVE_CFG)
    st = res.stats[0]
    out["serve"] = {k: st[k] for k in ("tokens", "prefill_logits", "last_logits",
                                       "moe_dropped_prefill", "moe_dropped_decode")}
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("ep") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    script = _SCRIPT % {"choices": CHOICES, "cfs": CFS, "x_shape": X_SHAPE}
    res = subprocess.run([sys.executable, "-c", script, str(path)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert "REF_OK" in res.stdout, res.stdout + res.stderr
    return dict(np.load(path))


@pytest.fixture(scope="module")
def ranks(ref):
    params = {k[2:]: v for k, v in ref.items() if k.startswith("p_")}
    return spawn(_rank, 4, "gloo", params, ref["x"], device="cpu")


def _gathered(ranks, name, cf, path):
    """The port's output over the whole batch: each data index's rows from
    its model-0 rank (every model rank holds the same rows)."""
    parts = {}
    for r in ranks:
        dpi, mi = r["coords"][name]
        if mi == 0:
            parts[dpi] = r[f"{name}_{cf}_{path}"][0]
    return torch.cat([parts[i] for i in sorted(parts)]).numpy()


CASES = [(name, cf, path) for name in MESHES for cf in CFS for path in PATHS]
IDS = [f"{n}-cf{cf}-{p}" for n, cf, p in CASES]


def test_router_gaps_leave_no_near_ties(ref):
    assert float(ref["gap"]) >= MIN_GAP


@pytest.mark.parametrize("name,cf,path", CASES, ids=IDS)
def test_ep_output_matches_reference(ref, ranks, name, cf, path):
    want = ref[f"{name}_{cf}_{path}_out"]
    got = _gathered(ranks, name, cf, path)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    for r in ranks:                       # the model ranks of a data index agree exactly
        dpi, _ = r["coords"][name]
        b = X_SHAPE[0] // 2
        assert np.array_equal(r[f"{name}_{cf}_{path}"][0].numpy(), got[dpi * b:(dpi + 1) * b])


@pytest.mark.parametrize("name,cf,path", CASES, ids=IDS)
def test_ep_kept_assignments_match_reference(ref, ranks, name, cf, path):
    for r in ranks:
        dpi, _ = r["coords"][name]
        shard = dpi if path == "ep" else 0
        got = r[f"{name}_{cf}_{path}"][2]
        for f in ("expert", "rank", "token", "kept"):
            assert np.array_equal(got[f], ref[f"{name}_{cf}_{path}_{shard}_{f}"]), f


@pytest.mark.parametrize("name,cf,path", CASES, ids=IDS)
def test_ep_aux_matches_reference(ref, ranks, name, cf, path):
    want = float(ref[f"{name}_{cf}_{path}_aux"])
    for r in ranks:
        assert abs(float(r[f"{name}_{cf}_{path}"][1]) - want) <= 1e-6


def test_low_capacity_drops_and_high_capacity_keeps_all(ranks):
    for name in MESHES:
        for path in PATHS:
            assert not ranks[0][f"{name}_0.5_{path}"][2]["kept"].all()
            assert ranks[0][f"{name}_8.0_{path}"][2]["kept"].all()


@pytest.mark.parametrize("name,path", [(n, p) for n in MESHES for p in PATHS])
def test_ep_equals_single_device_path_when_nothing_drops(ref, ranks, name, path):
    params = {k[2:]: v for k, v in ref.items() if k.startswith("p_")}
    cfg = cfg_of(8.0)
    with torch.no_grad():
        want, _ = moe.apply_moe(moe_from_jax(params, cfg, "cpu"), torch.from_numpy(ref["x"]), cfg)
    got = _gathered(ranks, name, 8.0, path)
    assert np.abs(got - want.numpy()).max() <= 2e-3 * float(want.abs().max())


def test_rank_shards_hold_their_experts(ranks):
    # E / model experts a rank, d / data of d_model with fsdp
    assert ranks[0]["2x2_8.0_shapes"] == ((4, 16, 16), (4, 16, 16))
    assert ranks[0]["2x1x2_8.0_shapes"] == ((4, 32, 16), (4, 16, 32))
    assert sorted(r["coords"]["2x2"] for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("case", CHOICES, ids=[c[0] for c in CHOICES])
def test_moe_path_matches_reference_choice(ref, name, case):
    label, e, fsdp, b, s = case
    assert moe.moe_path(cfg_of(1.0, e, fsdp), Mesh(*MESHES[name]), b, s) == \
        str(ref[f"choice_{name}_{label}"])


def test_shard_moe_params_cuts_expert_leaves_only():
    class FakeMesh:                     # the rank at data 1, model 0 of a (2, 2) mesh
        axis_names, shape = ("data", "model"), {"data": 2, "model": 2}

        def index(self, axes):
            return {"data": 1, "model": 0}[axes]

    g = np.random.default_rng(0)
    p = {"router": g.normal(size=(32, 8)), "wi": g.normal(size=(8, 32, 16)),
         "wg": g.normal(size=(8, 32, 16)), "wo": g.normal(size=(8, 16, 32)),
         "shared_wi": g.normal(size=(32, 16))}
    out = shard_moe_params(p, cfg_of(1.0), FakeMesh())
    assert np.array_equal(out["wi"], p["wi"][0:4, 16:32])
    assert np.array_equal(out["wo"], p["wo"][0:4, :, 16:32])
    assert out["router"] is p["router"] and out["shared_wi"] is p["shared_wi"]
    assert shard_moe_params(p, cfg_of(1.0, e=7), FakeMesh())["wi"] is p["wi"]


def test_sharded_serve_matches_one_process(ranks):
    """The reduced qwen3-moe served on the (2, 2) mesh (prefill through
    ``apply_moe_ep``, decode through ``apply_moe_ep_decode``) against one
    process: every greedy token equal, logits within 1e-4 of the largest."""
    one = serve(serve_cfg(), device="cpu", log=lambda *a: None, **SERVE_CFG).stats[0]
    by_dp = {}
    for r in ranks:
        dpi, mi = r["coords"]["2x2"]
        by_dp.setdefault(dpi, r["serve"])
        assert torch.equal(r["serve"]["tokens"], by_dp[dpi]["tokens"])
        assert r["serve"]["moe_dropped_prefill"] == 0.0
        assert r["serve"]["moe_dropped_decode"] == 0.0
    got = {k: torch.cat([by_dp[i][k] for i in sorted(by_dp)])
           for k in ("tokens", "prefill_logits", "last_logits")}
    assert torch.equal(got["tokens"], one["tokens"])
    for k in ("prefill_logits", "last_logits"):
        assert float((got[k] - one[k]).abs().max()) <= 1e-4 * float(one[k].abs().max())


def test_moe_refuses_to_run_its_shard_without_the_mesh():
    cfg = cfg_of(1.0)

    class FakeMesh:
        axis_names, shape = ("data", "model"), {"data": 2, "model": 2}

        def index(self, axes):
            return 0

    with meshctx.use_mesh(FakeMesh()):
        layer = moe.MoE(cfg)
    assert layer.wi.shape == (4, 16, 16)
    with pytest.raises(ValueError, match="shard"):
        moe.apply_moe(layer, torch.zeros((2, 1, 32)), cfg)
