"""Tensor parallelism over "model" for the dense and MoE stacks: the
program each rank runs under the reference's sharding rules
(``models/sharding.py``, ``models/tp.py``, ``models/attention.py``'s
``self_attention``), over four gloo ranks on the CPU.

The reference's draws of five reduced configs (biases and G 2, qwen2-like;
head norms, qwen3-like, with a cache length the model axis does not
divide, so the cache is split by kv heads; 3 query heads on 1 kv head,
which a model axis of 2 does not divide; an int8 cache; qwen3-moe with
``fsdp``) are prefilled and decoded for four greedy steps by the
reference's ``prefill`` / ``decode_step``, jitted with its rules'
``in_shardings`` on a (2, 2) host mesh with ``AxisType.Auto`` axes, in a
subprocess with four forced host devices. The port's ranks are spawned
once (``launch.mesh.spawn``); on a (2, 2) ("data", "model") and a (2, 1,
2) ("pod", "data", "model") mesh each loads the reference's draw cut to
its blocks (``weights.from_jax_params(..., mesh)``) and runs the same
steps on its rows, fed the reference's tokens, logging its collectives.
Held: logits within 1e-5 of max|logit| of one process and of the
reference, every rank's cache shard equal to one process's cache cut by
the rules, and each rank's collective log equal to the ``CountingMesh``'s
on ``meta`` at its coordinates. An int8 cache rounds a value half a code
from a level either way under another summation order, so its codes are
held within one code and, where any differs, its decode logits within
5e-2 of max|logit| (the bound of ``chip_smoke``'s int8 decode).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import decode_attn
from repro_torch.launch.mesh import CountingMesh, Mesh, ProcessMesh, collective_log, spawn
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import init_params, meshctx
from repro_torch.models import sharding as shd
from repro_torch.models.attention import merge_lse
from repro_torch.models.model import Model
from repro_torch.weights import cache_from_jax, from_jax_params

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x2": (("data", "model"), (2, 2)), "2x1x2": (("pod", "data", "model"), (2, 1, 2))}
# name: (arch, overrides, MoE capacity factor, prompt, cache slots)
CASES = {"qwen2": ("qwen2-7b", dict(n_heads=4, n_kv_heads=2, d_head=64), None, 12, 16),
         "qwen3": ("qwen3-1.7b", dict(n_heads=4, n_kv_heads=2, d_head=64), None, 13, 17),
         "odd": ("qwen2-7b", dict(d_model=192, n_heads=3, n_kv_heads=1, d_head=64, d_ff=384),
                 None, 12, 16),
         "kv8": ("qwen2-7b-kv8", dict(n_heads=4, n_kv_heads=2, d_head=64), None, 12, 16),
         "moe": ("qwen3-moe-30b-a3b", dict(n_heads=4, n_kv_heads=2, d_head=64, fsdp=True), 8.0,
                 12, 16)}
BATCH, STEPS = 4, 4
TOL = 1e-5
KV8_TOL = 5e-2

_SCRIPT = r"""
import dataclasses, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config, reduced
from repro.launch import steps
from repro.models import meshctx, model as jmodel, sharding as shd

CASES = %(cases)r
B, STEPS = %(batch)d, %(steps)d
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
meshctx.set_mesh(mesh)
out = {}
for name, (arch, kw, cf, prompt, slots) in CASES.items():
    cfg = reduced(get_config(arch), n_layers=2).replace(**kw)
    if cf:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (B, prompt), 0, cfg.vocab_size,
                                dtype=jnp.int32)
    psh = shd.params_shardings(mesh, params, cfg)
    batch = lambda t: shd.batch_shardings(mesh, {"t": t})["t"]
    pre = steps.make_prefill_step(cfg, slots)
    lst, cst = jax.eval_shape(pre, params, tokens)
    csh = shd.cache_shardings(mesh, cst, cfg)
    logits, cache = jax.jit(pre, in_shardings=(psh, batch(tokens)),
                            out_shardings=(batch(lst), csh))(params, tokens)
    serve = steps.make_serve_step(cfg)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    dec = jax.jit(serve, in_shardings=(psh, csh, batch(tok), NamedSharding(mesh, P())),
                  out_shardings=(batch(lst), csh))
    fed, outs = [], []
    for i in range(STEPS):
        fed.append(np.asarray(tok))
        logits_i, cache = dec(params, cache, tok, jnp.int32(prompt + i))
        outs.append(np.asarray(logits_i))
        tok = jnp.argmax(logits_i, -1)[:, None].astype(jnp.int32)
    out[name] = {"params": jax.tree_util.tree_map(np.asarray, params),
                 "tokens": np.asarray(tokens), "prefill": np.asarray(logits),
                 "fed": np.concatenate(fed, 1), "decode": np.stack(outs),
                 "cache": jax.tree_util.tree_map(np.asarray, cache)}
pickle.dump(out, open(sys.argv[1], "wb"))
print("REF_OK")
"""


def cfg_of(name):
    arch, kw, cf, _, _ = CASES[name]
    cfg = reduced(get_config(arch), n_layers=2).replace(**kw)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf)) if cf else cfg


def rows_of(mesh, n=BATCH):
    b = n // meshctx.dp_size(mesh)
    i = mesh.index(meshctx.dp_axes(mesh))
    return slice(i * b, (i + 1) * b)


@torch.no_grad()
def run_steps(model, cfg, tokens, fed, slots):
    """Prefill ``tokens``, then one decode step a column of ``fed``: (the
    prefill's logits, each step's, the cache, the prefill's collective
    log, the steps')."""
    with collective_log() as pre_log:
        logits, cache = make_prefill_step(cfg, slots)(model, tokens)
    step = make_serve_step(cfg)
    outs = []
    with collective_log() as dec_log:
        for i in range(fed.shape[1]):
            out, cache = step(model, cache, fed[:, i:i + 1], tokens.shape[1] + i)
            outs.append(out)
    return logits, torch.stack(outs), cache, list(pre_log), list(dec_log)


def lse_inputs(kind):
    """A decode call's inputs with an all-empty row: (q, k, v, pos, idx,
    scales)."""
    g = torch.Generator().manual_seed(7)
    b, s, hkv, grp, d = 3, 24, 2, 3, 32
    q = torch.randn((b, hkv * grp, d), generator=g)
    k, v = torch.randn((b, s, hkv, d), generator=g), torch.randn((b, s, hkv, d), generator=g)
    pos = torch.arange(s, dtype=torch.int32).repeat(b, 1)
    pos[1, 5:] = -1                    # a row that fills half the slots
    pos[2] = -1                        # a row with no valid slot
    scales = {}
    if kind == "int8":
        k = torch.randint(-127, 128, k.shape, generator=g).to(torch.int8)
        v = torch.randint(-127, 128, v.shape, generator=g).to(torch.int8)
        scales = {"k_scale": torch.rand((b, s, hkv), generator=g) * 0.05,
                  "v_scale": torch.rand((b, s, hkv), generator=g) * 0.05}
    return q, k, v, pos, s - 3, scales


def _rank(rank, device, ref):
    meshes = {name: ProcessMesh(*spec) for name, spec in MESHES.items()}
    out = {"coords": {name: {a: m.index(a) for a in m.axis_names} for name, m in meshes.items()}}
    for mname, mesh in meshes.items():
        rows = rows_of(mesh)
        for name, r in ref.items():
            cfg = cfg_of(name)
            with meshctx.use_mesh(mesh):
                model = from_jax_params(r["params"], cfg, "cpu", mesh)
                res = run_steps(model, cfg, torch.from_numpy(r["tokens"][rows]).long(),
                                torch.from_numpy(r["fed"][rows]).long(), CASES[name][4])
            out[(mname, name)] = res
    mesh = meshes["2x2"]
    with meshctx.use_mesh(mesh):     # draws under the mesh: the one-process draw's blocks
        model = init_params(cfg_of("moe"), torch.Generator().manual_seed(5), "cpu")
    out["init"] = [p.detach().clone() for p in model.parameters()]
    # two ranks' halves of a cache, merged through their log-sum-exps
    for kind in ("float", "int8"):
        q, k, v, pos, idx, scales = lse_inputs(kind)
        half = shd.block_of(k.shape[1], "model", mesh)
        o, lse = decode_attn.decode_attention(
            q, k[:, half], v[:, half], pos[:, half].contiguous(), idx, return_lse=True,
            **{n: t[:, half] for n, t in scales.items()})
        out[("merge", kind)] = merge_lse(o, lse, mesh)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    script = _SCRIPT % {"cases": CASES, "batch": BATCH, "steps": STEPS}
    res = subprocess.run([sys.executable, "-c", script, str(path)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert "REF_OK" in res.stdout, res.stdout + res.stderr
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks(ref):
    return spawn(_rank, 4, "gloo", ref, device="cpu")


@pytest.fixture(scope="module")
def one(ref):
    """Each case in one process, no mesh, fed the reference's tokens."""
    out = {}
    for name, r in ref.items():
        cfg = cfg_of(name)
        model = from_jax_params(r["params"], cfg, "cpu")
        out[name] = run_steps(model, cfg, torch.from_numpy(r["tokens"]).long(),
                              torch.from_numpy(r["fed"]).long(), CASES[name][4])
    return out


def gathered(ranks, mname, name, i):
    """Result ``i`` of a case over the whole batch: each data index's rows
    from its model-0 rank, the model ranks of a data index checked equal."""
    by_dp = {}
    for r in ranks:
        c = r["coords"][mname]
        dpi = c["pod"] if mname == "2x1x2" else c["data"]
        got = r[(mname, name)][i]
        if dpi in by_dp:
            assert torch.equal(by_dp[dpi], got)
        by_dp[dpi] = got
    return torch.cat([by_dp[k] for k in sorted(by_dp)], dim=0 if i == 0 else 1)


def codes_differ(ranks, one, mname, name):
    """Whether any int8 code of a rank's cache differs from one process's
    (each within one code, asserted)."""
    differ = False
    for r in ranks:
        mesh = CountingMesh(Mesh(*MESHES[mname]), r["coords"][mname])
        want = shd.cut_cache(one[name][2], mesh)
        for e_got, e_want in zip(r[(mname, name)][2], want):
            for leaf in ("k", "v"):
                d = (e_got[leaf].to(torch.int32) - e_want[leaf].to(torch.int32)).abs()
                assert int(d.max()) <= 1
                differ |= bool(d.any())
    return differ


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


CASE_IDS = [(m, n) for m in MESHES for n in CASES]


@pytest.mark.parametrize("mname,name", CASE_IDS, ids=[f"{m}-{n}" for m, n in CASE_IDS])
def test_prefill_logits_equal_one_process(ranks, one, mname, name):
    assert rel(gathered(ranks, mname, name, 0), one[name][0]) <= TOL


@pytest.mark.parametrize("mname,name", CASE_IDS, ids=[f"{m}-{n}" for m, n in CASE_IDS])
def test_decode_logits_equal_one_process(ranks, one, mname, name):
    err = rel(gathered(ranks, mname, name, 1), one[name][1])
    if cfg_of(name).kv_quant_bits and codes_differ(ranks, one, mname, name):
        assert err <= KV8_TOL
    else:
        assert err <= TOL


@pytest.mark.parametrize("mname,name", CASE_IDS, ids=[f"{m}-{n}" for m, n in CASE_IDS])
def test_cache_shards_are_one_process_cache_cut(ranks, one, mname, name):
    cfg = cfg_of(name)
    for r in ranks:
        mesh = CountingMesh(Mesh(*MESHES[mname]), r["coords"][mname])
        want = shd.cut_cache(one[name][2], mesh)
        got = r[(mname, name)][2]
        assert len(got) == len(want) == cfg.n_layers
        for e_got, e_want in zip(got, want):
            assert sorted(e_got) == sorted(e_want)
            for leaf, t in e_want.items():
                assert e_got[leaf].shape == t.shape, leaf
                if leaf == "pos":
                    assert torch.equal(e_got[leaf], t)
                elif t.dtype == torch.int8:
                    assert int((e_got[leaf].int() - t.int()).abs().max()) <= 1
                else:
                    assert float((e_got[leaf] - t).abs().max()) <= TOL * float(t.abs().max())
    # the cache is split by length where the model axis divides it, else by kv heads
    e = ranks[0][(mname, name)][2][0]
    slots = CASES[name][4]
    if slots % 2 == 0:
        assert e["k"].shape[1] == slots // 2 and e["pos"].shape[1] == slots // 2
    else:
        assert e["k"].shape[1:3] == (slots, cfg.n_kv_heads // 2)


@pytest.mark.parametrize("name", CASES)
def test_logits_equal_the_references_partitioned_steps(ref, ranks, one, name):
    r = ref[name]
    assert rel(gathered(ranks, "2x2", name, 0), torch.from_numpy(r["prefill"])) <= TOL
    err = rel(gathered(ranks, "2x2", name, 1), torch.from_numpy(r["decode"]))
    if cfg_of(name).kv_quant_bits:
        # codes within one of the reference's, as tests/test_torch_zoo.py holds them
        want = cache_from_jax(r["cache"], cfg_of(name), "cpu")
        differ = False
        for e_got, e_want in zip(one[name][2], want):
            d = (e_got["k"].int() - e_want["k"].int()).abs()
            assert int(d.max()) <= 1
            differ |= bool(d.any())
        assert err <= (KV8_TOL if differ or codes_differ(ranks, one, "2x2", name) else TOL)
    else:
        assert err <= TOL


@pytest.mark.parametrize("mname,name", CASE_IDS, ids=[f"{m}-{n}" for m, n in CASE_IDS])
def test_collective_log_equals_the_counting_mesh(ref, ranks, mname, name):
    cfg = cfg_of(name)
    r0 = ref[name]
    for r in ranks:
        mesh = CountingMesh(Mesh(*MESHES[mname]), r["coords"][mname])
        rows = rows_of(mesh)
        meta = lambda a: torch.empty(a[rows].shape, dtype=torch.long, device="meta")
        with meshctx.use_mesh(mesh):
            model = Model(cfg, device="meta")
            *_, pre_log, dec_log = run_steps(model, cfg, meta(r0["tokens"]), meta(r0["fed"]),
                                             CASES[name][4])
        assert r[(mname, name)][3] == pre_log
        assert r[(mname, name)][4] == dec_log
        assert {k for k, _, _ in pre_log} == {"all-gather", "all-reduce"}


def test_init_params_under_a_mesh_draws_the_one_process_numbers(ranks):
    cfg = cfg_of("moe")
    whole = list(init_params(cfg, torch.Generator().manual_seed(5), "cpu").parameters())
    for r in ranks:
        mesh = CountingMesh(Mesh(*MESHES["2x2"]), r["coords"]["2x2"])
        with meshctx.use_mesh(mesh):
            specs = Model(cfg, device="meta")
        for p, w, got in zip(specs.parameters(), whole, r["init"]):
            assert torch.equal(got, shd.cut(w, p.spec, mesh))


def test_rules_cut_the_dense_leaves():
    cfg = cfg_of("qwen2")
    mesh = CountingMesh(Mesh(*MESHES["2x2"]), {"data": 1, "model": 1})
    with meshctx.use_mesh(mesh):
        model = Model(cfg, device="meta")
    blk = model.blocks[0]
    assert blk.attn.wq.spec == (None, "model") and blk.attn.wq.shape == (256, 128)
    assert blk.attn.bq.spec == ("model",) and blk.attn.wo.spec == ("model", None)
    assert blk.mlp.wo.spec == ("model", None) and blk.ln1.scale.spec == (None,)
    assert model.embed.spec == ("model", None) and model.embed.shape == (256, 256)
    assert model.lm_head.spec == (None, "model")
    fsdp = cfg_of("moe")
    with meshctx.use_mesh(mesh):
        model = Model(fsdp, device="meta")
    assert model.embed.spec == ("model", "data") and model.embed.shape == (256, 128)
    assert model.blocks[0].moe.router.spec == ("data", None)
    assert model.blocks[0].moe.wi.spec == ("model", "data", None)


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("window", [0, 9])
def test_plain_lse_is_the_float64_logsumexp(kind, window):
    q, k, v, pos, idx, scales = lse_inputs(kind)
    o, lse = decode_attn.decode_attention(q, k, v, pos, idx, window=window, return_lse=True,
                                          **scales)
    assert torch.equal(o, decode_attn.decode_attention(q, k, v, pos, idx, window=window,
                                                       **scales))
    b, hq, d = q.shape
    hkv = k.shape[2]
    kf = k.double() * (scales["k_scale"].double()[..., None] if scales else 1.0)
    s = torch.einsum("bhgd,bshd->bhgs", q.double().reshape(b, hkv, hq // hkv, d) * d ** -0.5, kf)
    valid = (pos >= 0) & (pos <= idx)
    if window:
        valid &= pos > idx - window
    s = torch.where(valid[:, None, None], s, -1e30)
    want = torch.logsumexp(s, -1).reshape(b, hq)
    assert float((lse[:2].double() - want[:2]).abs().max()) <= 1e-5 * float(want[:2].abs().max())
    # the empty row: -1e30 + log S, which is -1e30 in float32
    assert torch.all(lse[2] == torch.tensor(-1e30, dtype=torch.float32))


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_merge_of_two_halves_equals_the_whole(ranks, kind):
    q, k, v, pos, idx, scales = lse_inputs(kind)
    whole = decode_attn.decode_attention(q, k, v, pos, idx, **scales)
    for r in ranks:
        got = r[("merge", kind)]
        assert float((got - whole).abs().max()) <= 1e-5 * float(whole.abs().max())
    # the empty row is the mean of v over all the slots, as one run gives it
    assert torch.allclose(ranks[0][("merge", kind)][2], whole[2], atol=1e-6)
