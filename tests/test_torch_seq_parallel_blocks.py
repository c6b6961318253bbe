"""The sequence-parallel residual (``seq_parallel_residual``,
``meshctx.seq_parallel``) of the ``dense``, ``moe``, ``lattn``, ``rec``,
``enc``, ``decx`` and ``xattn`` blocks, with the flag forced on, over four
gloo ranks of a (2, 2) ("data", "model") mesh on the CPU: each residual
branch runs its norm on the rank's block of the sequence, all-gathers the
normed output, runs its sublayer on the whole sequence and reduce-scatters
its row-parallel output along the sequence where the flag-off program
all-reduces it.

Reduced float32 configs, each block type present: qwen3-1.7b (dense; 4
query on 2 kv heads); qwen3-moe-30b-a3b (moe; ``fsdp`` as published, so
its prefill and train step, of at most 4096 tokens, take the
expert-parallel "ep_decode" path; capacity factor 8, which drops
nothing); recurrentgemma-9b (rec, rec, lattn; one kv head, a 32-slot
ring); seamless-m4t-large-v2 (2 enc and 2 decx layers; 3 heads and a
vocab of 511, which the model axis divides neither; its encoder is
sequence-parallel at prefill too, as the reference runs it in train
mode); llama-3.2-vision-90b (its pattern cut to dense, xattn; ``fsdp``,
Adafactor). On the ranks only, held flag on against flag off:
kimi-k2-1t-a32b without ``fsdp`` (the "ep" path with its shared expert,
Adafactor) and qwen3-moe with 3 experts, which the model axis does not
divide (the global path over whole experts), both at capacity factor 0.5,
which drops assignments. The
cross-attention gates and the aux_embeds are drawn from a seed.

The reference's ``prefill``, 2 greedy ``decode_step``\\ s and one step of
``make_train_step(cfg, warmup=0)`` (and ``jax.grad`` of its loss) run with
the flag on, jitted with its rules' shardings on an ``AxisType.Auto``
(2, 2) host mesh, in two subprocesses with four forced host devices
(``tests/test_torch_tp_blocks.py``'s harness). The port's ranks are
spawned once; each loads the reference's draw cut to its blocks
(``weights.from_jax_params(..., mesh)``) and, with the flag on and off,
prefills its rows, decodes 2 steps fed the reference's tokens, takes one
train step, and runs the edges: a 13-token prompt, which the model axis
does not divide, and the whole batch under ``whole_batch()``.

Held: prefill and decode logits, flag on against off, bit for bit; within
1e-5 of max|logit| of one process and of the reference; every rank's
cache shard bit for bit the flag-off shard and within 1e-5 of each leaf's
largest of one process's cache cut by the rules; the MoE routing logs
(prefill, decode and train) equal to the flag-off logs, field for field;
step 1's metrics within 1e-5 relative of the flag-off step's, one
process's and the reference's; the parameters after it within 0.1 x lr of
all three (the bound of ``tests/test_torch_tp_blocks.py``, with its rule
for elements whose gradient is within 1e-5 of their leaf's largest, which
AdamW's first step moves by lr either way); each rank's flag-on logs equal
to the ``CountingMesh``'s on meta; the flag-on prefill log the flag-off
log with each branch's all-reduce turned into an all-gather and a
reduce-scatter, plus a gather at each stack's end; the edges' and the
decode's logs and logits those of the flag-off program. On meta, every
arch at its published widths runs a sequence-parallel prefill.
"""
import collections
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.launch.mesh import (CountingMesh, Mesh, ProcessMesh, collective_log, spawn)
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models import init_params, meshctx
from repro_torch.models import moe as moe_lib
from repro_torch.models import sharding as shd
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import Model
from repro_torch.weights import from_jax_params, reference_leaves

from test_torch_tp_blocks import ROOT, _at, the_batch

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

MESH = (("data", "model"), (2, 2))
HEADS = dict(n_heads=4, n_kv_heads=2, d_head=64)
# name: (arch, layers, overrides, prompt, cache slots); "capacity_factor" and
# "n_experts" are the MoE's
CASES = {"dense": ("qwen3-1.7b", 2, HEADS, 12, 16),
         "moe": ("qwen3-moe-30b-a3b", 2, dict(HEADS, fsdp=True, capacity_factor=8.0), 12, 16),
         "rg": ("recurrentgemma-9b", 3, dict(window=32), 14, 18),
         "seamless": ("seamless-m4t-large-v2", 2,
                      dict(d_model=192, n_heads=3, n_kv_heads=3, d_head=64, d_ff=384,
                           vocab_size=511), 12, 16),
         "llama": ("llama-3.2-vision-90b", 5,
                   dict(n_layers=2, block_pattern=("dense", "xattn"), fsdp=True, **HEADS), 12, 16)}
# held flag on against off only: the "ep" path routes a rank's tokens at its own
# capacity and averages the aux over the data ranks, where one process routes all;
# 3 experts, which the model axis does not divide, take the global path
PORT_ONLY = {"kimi": ("kimi-k2-1t-a32b", 2, dict(fsdp=False, capacity_factor=0.5), 12, 16),
             "moe3": ("qwen3-moe-30b-a3b", 2, dict(HEADS, n_experts=3, capacity_factor=0.5),
                      12, 16)}
ALL = dict(CASES, **PORT_ONLY)
MOE = ("moe", "kimi", "moe3")
# residual branches and reduce-scatters of a prefill; stack ends (decoder, encoder)
BRANCHES = {"dense": (4, 4, 1), "moe": (4, 4, 1), "rg": (6, 6, 1), "seamless": (10, 10, 2),
            "llama": (4, 4, 1), "kimi": (4, 6, 1),   # kimi: its shared expert scatters too
            "moe3": (4, 2, 1)}   # whole experts: the rank takes its block, nothing summed
BATCH, DECODE, ODD, LR = 4, 2, 13, 3e-4
TOL = 1e-5            # logits x max|logit|; metrics relative; cache x the leaf's largest
PARAM_TOL = 0.1 * LR  # parameters after one step, absolute
PARAM_OUTLIERS = 2    # elements of a leaf allowed past PARAM_TOL, each within 2 x lr,
NEAR_ZERO = 1e-5      # and each with a step-1 gradient within 1e-5 of the leaf's largest
METRICS = ("loss", "ce", "aux", "grad_norm")
FLAGS = (True, False)

_SCRIPT = r"""
import dataclasses, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config, reduced
from repro.launch import steps
from repro.models import meshctx, model as jmodel, sharding as shd
from repro.optim.optimizers import opt_state_pspec

CASES = %(cases)r
B, STEPS, LR = %(batch)d, %(steps)d, %(lr)r
train_batch = {k: np.asarray(v, np.int32) for k, v in %(train)r.items()}
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
meshctx.set_mesh(mesh)


def with_gates(tree, rng):
    if isinstance(tree, dict):
        return {k: (rng.uniform(0.5, 1.5, np.shape(v)).astype(np.asarray(v).dtype)
                    if k == "gate" else with_gates(v, rng)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(with_gates(v, rng) for v in tree)
    return np.asarray(tree)


out = {}
for name, (arch, layers, kw, prompt, slots) in CASES.items():
    kw = dict(kw, seq_parallel_residual=True)
    cf = kw.pop("capacity_factor", None)
    cfg = reduced(get_config(arch), n_layers=layers).replace(**kw)
    if cf:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    params = with_gates(jax.tree_util.tree_map(np.asarray, jmodel.init_params(
        cfg, jax.random.PRNGKey(0))), np.random.default_rng(5))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (B, prompt), 0, cfg.vocab_size,
                                dtype=jnp.int32)
    aux = (jnp.asarray(np.random.default_rng(3).standard_normal(
        (B, cfg.n_aux_tokens, cfg.d_model)).astype(np.float32)) if cfg.n_aux_tokens else None)
    psh = shd.params_shardings(mesh, params, cfg)
    batch = lambda t: shd.batch_shardings(mesh, {"t": t})["t"]
    pre = steps.make_prefill_step(cfg, slots)
    inputs = (tokens,) if aux is None else (tokens, aux)
    lst, cst = jax.eval_shape(pre, params, *inputs)
    csh = shd.cache_shardings(mesh, cst, cfg)
    logits, cache = jax.jit(pre, in_shardings=(psh,) + tuple(batch(t) for t in inputs),
                            out_shardings=(batch(lst), csh))(params, *inputs)
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
    tb = {k: jnp.asarray(v) for k, v in train_batch.items()}
    if aux is not None:
        tb["aux_embeds"] = aux
    train_step, opt_init = steps.make_train_step(cfg, base_lr=LR, warmup=0)
    state = opt_init(params)
    pspecs = shd.params_pspecs(mesh, params, cfg)
    shard = (shd.wrap(mesh, pspecs), shd.wrap(mesh, opt_state_pspec(cfg.optimizer, pspecs)),
             shd.batch_shardings(mesh, tb))
    mstruct = jax.eval_shape(train_step, params, state, tb)[2]
    msh = jax.tree_util.tree_map(lambda _: NamedSharding(mesh, P()), mstruct)
    args = jax.device_put((params, state, tb), shard)
    step = jax.jit(train_step, in_shardings=shard, out_shardings=shard[:2] + (msh,))
    grad = jax.jit(jax.grad(lambda p, b: jmodel.loss_fn(p, cfg, b)[0]),
                   in_shardings=(shard[0], shard[2]), out_shardings=shard[0])
    g1 = grad(args[0], args[2])
    p1, _, m1 = step(*args)
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
    out[name] = {"params": np_(params), "tokens": np.asarray(tokens),
                 "aux": None if aux is None else np.asarray(aux),
                 "prefill": np.asarray(logits), "fed": np.concatenate(fed, 1),
                 "decode": np.stack(outs), "params1": np_(p1), "grads1": np_(g1),
                 "metrics": {k: float(v) for k, v in m1.items()}}
pickle.dump(out, open(sys.argv[1], "wb"))
print("REF_OK")
"""
# the reference's cases in two subprocesses run side by side (its compiles take the time)
REF_JOBS = (("dense", "moe", "seamless"), ("rg", "llama"))


def cfg_of(name, flag=True):
    arch, layers, kw, _, _ = ALL[name]
    kw = dict(kw, seq_parallel_residual=flag)
    moe = {k: kw.pop(k) for k in ("capacity_factor", "n_experts") if k in kw}
    cfg = reduced(get_config(arch), n_layers=layers).replace(**kw)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **moe)) if moe else cfg


def port_only_draw(name):
    """A port-only case's tokens (B, prompt), fed tokens (B, DECODE) and
    aux (None), from numpy's seeded generator, in the reference's layout."""
    rng = np.random.default_rng(2)
    cfg = cfg_of(name)
    return {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, ALL[name][3])),
            "fed": rng.integers(0, cfg.vocab_size, (BATCH, DECODE)), "aux": None}


def rows_of(mesh):
    b = BATCH // meshctx.dp_size(mesh)
    i = mesh.index(meshctx.dp_axes(mesh))
    return slice(i * b, (i + 1) * b)


def inputs_of(r, rows):
    """A case's serve tokens, aux_embeds and fed tokens, its train batch
    and its 13-token prompt (the batch's first 13 tokens), at ``rows``."""
    t = lambda a: torch.from_numpy(np.asarray(a)[rows]).long()
    batch = {k: torch.from_numpy(v[rows]) for k, v in the_batch().items()}
    aux = None if r["aux"] is None else torch.from_numpy(r["aux"][rows])
    if aux is not None:
        batch["aux_embeds"] = aux
    return {"tokens": t(r["tokens"]), "aux": aux, "fed": t(r["fed"]), "batch": batch,
            "odd": batch["tokens"][:, :ODD].long()}


def build(name, cfg, r, mesh=None):
    """The case's model: the reference's draw (cut to the rank's blocks
    under ``mesh``), or for a port-only case the port's seeded draw."""
    if name in PORT_ONLY:
        return init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return from_jax_params(r["params"], cfg, "cpu", mesh)


@torch.no_grad()
def serve(model, cfg, x, slots):
    """Prefill and ``DECODE`` steps fed ``x["fed"]``: (prefill logits,
    the steps' logits, cache, prefill log, decode log, routing calls)."""
    with moe_lib.routing_log() as routes:
        with collective_log() as pre_log:
            logits, cache = make_prefill_step(cfg, slots)(model, x["tokens"], x["aux"])
        step = make_serve_step(cfg)
        outs = []
        with collective_log() as dec_log:
            for i in range(x["fed"].shape[1]):
                out, cache = step(model, cache, x["fed"][:, i:i + 1], x["tokens"].shape[1] + i)
                outs.append(out)
    return logits, torch.stack(outs), cache, list(pre_log), list(dec_log), routes.calls


def train(model, cfg, batch):
    """One train step: (metrics, the parameters after it, the log, the
    routing calls)."""
    train_step, opt_init = make_train_step(cfg, base_lr=LR, warmup=0)
    state = opt_init(model)
    with moe_lib.routing_log() as routes, collective_log() as log:
        model, state, m = train_step(model, state, batch)
    metrics = {k: float(v) for k, v in m.items()} if m["loss"].device.type != "meta" else {}
    return metrics, [p.detach().clone() for p in model.parameters()], list(log), routes.calls


@torch.no_grad()
def prefill_log(model, cfg, tokens, aux, slots, whole=False):
    """The logits and collective log of a prefill (of a whole batch under
    ``whole_batch()`` where ``whole``)."""
    with collective_log() as log, meshctx.whole_batch(whole):
        logits, _ = make_prefill_step(cfg, slots)(model, tokens, aux)
    return logits, list(log)


def _rank(rank, device, ref):
    mesh = ProcessMesh(*MESH)
    rows = rows_of(mesh)
    out = {"coords": {a: mesh.index(a) for a in mesh.axis_names}}
    for name in ALL:
        r, slots = ref[name], ALL[name][4]
        x, whole = inputs_of(r, rows), inputs_of(r, slice(None))
        for flag in FLAGS:
            cfg = cfg_of(name, flag)
            with meshctx.use_mesh(mesh):
                res = {"serve": serve(build(name, cfg, r, mesh), cfg, x, slots)}
                model = build(name, cfg, r, mesh)
                res["odd"] = prefill_log(model, cfg, x["odd"], x["aux"], slots)
                res["whole"] = prefill_log(model, cfg, whole["tokens"], whole["aux"], slots,
                                           whole=True)
                res["train"] = train(model, cfg, x["batch"])
            out[(name, flag)] = res
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spb")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    jobs = []
    for i, names in enumerate(REF_JOBS):
        script = _SCRIPT % {"cases": {n: CASES[n] for n in names}, "batch": BATCH,
                            "steps": DECODE, "lr": LR,
                            "train": {k: v.tolist() for k, v in the_batch().items()}}
        jobs.append((tmp / f"ref{i}.pkl", subprocess.Popen(
            [sys.executable, "-c", script, str(tmp / f"ref{i}.pkl")], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    out = {}
    for path, proc in jobs:
        stdout, stderr = proc.communicate(timeout=900)
        assert "REF_OK" in stdout, stdout + stderr
        with open(path, "rb") as f:
            out.update(pickle.load(f))
    out.update({name: port_only_draw(name) for name in PORT_ONLY})
    return out


@pytest.fixture(scope="module")
def ranks(ref):
    light = {name: {k: r[k] for k in ("params", "tokens", "aux", "fed") if k in r}
             for name, r in ref.items()}
    return spawn(_rank, 4, "gloo", light, device="cpu")


@pytest.fixture(scope="module")
def one(ref):
    """Each reference case in one process, no mesh (the flag on, which
    then changes nothing), fed the reference's tokens."""
    out = {}
    for name in CASES:
        cfg, x = cfg_of(name), inputs_of(ref[name], slice(None))
        out[name] = {"serve": serve(build(name, cfg, ref[name]), cfg, x, CASES[name][4]),
                     "train": train(build(name, cfg, ref[name]), cfg, x["batch"])}
    return out


def counting(coords):
    return CountingMesh(Mesh(*MESH), coords)


def gathered(ranks, name, flag, i):
    """Serve result ``i`` (0 the prefill's logits (B, V), 1 the decode
    steps' (steps, B, V)) over the whole batch: each data index's rows from
    its model-0 rank, the model ranks of a data index checked equal."""
    by_dp = {}
    for r in ranks:
        got = r[(name, flag)]["serve"][i]
        dpi = r["coords"]["data"]
        if dpi in by_dp:
            assert torch.equal(by_dp[dpi], got)
        by_dp[dpi] = got
    return torch.cat([by_dp[k] for k in sorted(by_dp)], dim=i)


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def rel_scalar(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


# ---------------------------------------------------------------- values
@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("i,what", [(0, "prefill"), (1, "decode")])
def test_logits_equal_the_flag_off_program_one_process_and_the_reference(ranks, one, ref, name,
                                                                         i, what):
    on = gathered(ranks, name, True, i)
    assert torch.equal(on, gathered(ranks, name, False, i))
    if name in CASES:
        assert rel(on, one[name]["serve"][i]) <= TOL
        assert rel(on, torch.from_numpy(ref[name][what])) <= TOL


@pytest.mark.parametrize("name", ALL)
def test_cache_shards_equal_the_flag_off_shards_and_one_process_cut(ranks, one, name):
    """The cache entries come from the whole sequence, gathered in each
    branch, so they are the flag-off program's bit for bit, and one
    process's cache cut by the rules."""
    for r in ranks:
        on, off = r[(name, True)]["serve"][2], r[(name, False)]["serve"][2]
        assert len(on) == len(off) == cfg_of(name).n_layers
        for e_on, e_off in zip(on, off):
            assert sorted(e_on) == sorted(e_off)
            for leaf, t in e_off.items():
                assert torch.equal(e_on[leaf], t), leaf
        if name not in CASES:
            continue
        for e_on, e_want in zip(on, shd.cut_cache(one[name]["serve"][2], counting(r["coords"]))):
            assert sorted(e_on) == sorted(e_want)
            for leaf, t in e_want.items():
                assert e_on[leaf].shape == t.shape, leaf
                assert float((e_on[leaf] - t).abs().max()) <= TOL * float(t.abs().max()), leaf


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("part", ["serve", "train"])
def test_routing_logs_equal_the_flag_off_logs(ranks, one, name, part):
    """The MoE routes the gathered, whole sequence: every call's routing
    (path, capacity, drops) is the flag-off call's; the port-only cases
    drop some assignments, qwen3-moe's none, as one process's."""
    at = 5 if part == "serve" else 3
    for r in ranks:
        on, off = r[(name, True)][part][at], r[(name, False)][part][at]
        assert len(on) == len(off) == (1 + DECODE if part == "serve" else 1) * 2
        for a, b in zip(on, off):
            for f in dataclasses.fields(a):
                va, vb = getattr(a, f.name), getattr(b, f.name)
                assert torch.equal(va, vb) if torch.is_tensor(va) else va == vb, f.name
        dropped = moe_lib.RoutingLog()
        dropped.calls = on
        share = dropped.dropped_share()
        if name in CASES:
            mine = moe_lib.RoutingLog()
            mine.calls = one[name][part][at]
            assert share == mine.dropped_share() == 0.0
        else:
            assert share > 0


@pytest.mark.parametrize("name", ALL)
def test_train_metrics_equal_the_flag_off_program_one_process_and_the_reference(ranks, one, ref,
                                                                               name):
    for r in ranks:
        got = r[(name, True)]["train"][0]
        for k in METRICS:
            assert rel_scalar(got[k], r[(name, False)]["train"][0][k]) <= TOL, k
            if name in CASES:
                assert rel_scalar(got[k], one[name]["train"][0][k]) <= TOL, k
                assert rel_scalar(got[k], ref[name]["metrics"][k]) <= TOL, k


@pytest.mark.parametrize("name", ALL)
def test_parameters_after_a_step(ranks, one, ref, name):
    """Within 0.1 x lr of the flag-off step's, one process's and the
    reference's (cut to the rank's blocks); past it only elements whose
    step-1 gradient (the reference's) is within ``NEAR_ZERO`` of the
    leaf's largest: at most ``PARAM_OUTLIERS`` a leaf of more than 2."""
    cfg = cfg_of(name)
    for r in ranks:
        mesh = counting(r["coords"])
        on, off = r[(name, True)]["train"][1], r[(name, False)]["train"][1]
        for a, b in zip(on, off):
            assert float((a - b).abs().max()) <= PARAM_TOL
        if name not in CASES:
            continue
        with meshctx.use_mesh(mesh):
            specs = Model(cfg, device="meta")
        params = list(specs.parameters())
        for leaf in reference_leaves(specs):
            a = np.asarray(_at(ref[name]["params1"], leaf.path))
            gr = np.asarray(_at(ref[name]["grads1"], leaf.path))
            for gi, i in enumerate(leaf.index):
                want = torch.from_numpy(np.asarray(a[gi] if leaf.stacked else a))
                g = torch.from_numpy(np.asarray(gr[gi] if leaf.stacked else gr))
                cut = lambda t: shd.cut(t, params[i].spec, mesh)
                near = cut(g).abs() / g.abs().max()
                for w in (want, one[name]["train"][1][i]):
                    gap = (on[i] - cut(w)).abs()
                    past = gap > PARAM_TOL
                    if past.any():
                        assert want.numel() > 2, (leaf.path, float(gap.max()) / LR)
                        assert int(past.sum()) <= PARAM_OUTLIERS, leaf.path
                        assert float(near[past].max()) <= NEAR_ZERO, (leaf.path, near[past])
                        assert float(gap.max()) <= 2 * LR, leaf.path


# ------------------------------------------------------------ the program
def meta_logs(name, coords):
    """The flag-on prefill, decode and train logs of the rank at
    ``coords``, counted on meta under a ``CountingMesh``."""
    cfg = cfg_of(name)
    b = BATCH // MESH[1][0]
    meta = lambda *shape, dt=torch.long: torch.empty(shape, dtype=dt, device="meta")
    aux = meta(b, cfg.n_aux_tokens, cfg.d_model, dt=torch.float32) if cfg.n_aux_tokens else None
    x = {"tokens": meta(b, ALL[name][3]), "aux": aux, "fed": meta(b, DECODE)}
    batch = {"tokens": meta(b, 16), "labels": meta(b, 16)}
    if aux is not None:
        batch["aux_embeds"] = aux
    with meshctx.use_mesh(counting(coords)):
        pre, dec = serve(Model(cfg, device="meta"), cfg, x, ALL[name][4])[3:5]
        log = train(Model(cfg, device="meta"), cfg, batch)[2]
    return pre, dec, log


@pytest.mark.parametrize("name", ALL)
def test_collective_logs_equal_the_counting_mesh(ranks, name):
    for r in ranks:
        pre, dec, log = meta_logs(name, r["coords"])
        got = r[(name, True)]
        assert got["serve"][3] == pre
        assert got["serve"][4] == dec
        assert got["train"][2] == log


@pytest.mark.parametrize("name", ALL)
def test_each_branch_turns_its_all_reduce_into_a_gather_and_a_reduce_scatter(ranks, name):
    """Flag on against off, a prefill's log: each residual branch adds an
    all-gather of its normed input, and each all-reduce of a branch's
    row-parallel output (kimi's MoE branch has two: the routed and the
    shared experts) becomes a reduce-scatter of 1 / model of its bytes;
    each stack (the decoder's, seamless's encoder's) gathers its residual
    at its end. Nothing else changes."""
    branches, scatters, ends = BRANCHES[name]
    m = MESH[1][1]
    for r in ranks:
        on, off = r[(name, True)]["serve"][3], r[(name, False)]["serve"][3]
        c_on, c_off = collections.Counter(on), collections.Counter(off)
        rs = [e for e in on if e[0] == "reduce-scatter"]
        assert len(rs) == scatters
        gone = collections.Counter(("all-reduce", n * m, k) for _, n, k in rs)
        ar = lambda c: collections.Counter({e: n for e, n in c.items() if e[0] == "all-reduce"})
        assert ar(c_off) - ar(c_on) == gone and not ar(c_on) - ar(c_off)
        ag = lambda c: collections.Counter({e: n for e, n in c.items() if e[0] == "all-gather"})
        new = ag(c_on) - ag(c_off)
        assert not ag(c_off) - ag(c_on) and sum(new.values()) == branches + ends
        assert c_on - c_off == new + collections.Counter(rs)


@pytest.mark.parametrize("name", ALL)
def test_a_train_steps_all_reduces_become_gathers_and_scatters(ranks, name):
    """A train step's log, flag on against off: the reduce-scatters
    outnumber the flag-off step's by at least the forward's branches
    (their all-reduces, and the backward's, turned into reduce-scatters
    and all-gathers), and it all-reduces fewer times."""
    scatters = BRANCHES[name][1]
    for r in ranks:
        on, off = r[(name, True)]["train"][2], r[(name, False)]["train"][2]
        kinds = lambda log, k: sum(1 for e in log if e[0] == k)
        assert kinds(on, "reduce-scatter") >= kinds(off, "reduce-scatter") + scatters
        assert kinds(on, "all-reduce") <= kinds(off, "all-reduce") - scatters


@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("edge", ["odd", "whole", "decode"])
def test_edges_run_the_flag_off_program_exactly(ranks, name, edge):
    """S = 13 on a model axis of 2, the whole batch under
    ``whole_batch()``, and decode: the flag changes neither the log nor
    the logits. seamless's encoder runs over its own 16 frames, which the
    axis divides, so under a 13-token prompt it alone stays
    sequence-parallel: one reduce-scatter a branch of its layers."""
    enc = cfg_of(name).encoder
    for r in ranks:
        on, off = r[(name, True)], r[(name, False)]
        if edge == "decode":
            (l_on, log_on), (l_off, log_off) = ((x["serve"][1], x["serve"][4]) for x in (on, off))
        else:
            (l_on, log_on), (l_off, log_off) = on[edge], off[edge]
        scatters = sum(k == "reduce-scatter" for k, _, _ in log_on)
        if edge == "odd" and enc is not None:
            assert scatters == 2 * enc.n_layers
        else:
            assert log_on == log_off and scatters == 0
        assert torch.equal(l_on, l_off)


# --------------------------------------------------------------- on meta
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_runs_sequence_parallel_at_its_published_widths(arch):
    """One layer group of each arch at its published widths, the flag on,
    on meta under a (2, 2) counting mesh: a prefill of a 16-token prompt
    reduce-scatters in every residual branch whose output is cut over
    "model", with no block type refused."""
    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=len(cfg.block_pattern), seq_parallel_residual=True)
    meta = lambda *shape, dt=torch.long: torch.empty(shape, dtype=dt, device="meta")
    aux = meta(2, cfg.n_aux_tokens, cfg.d_model, dt=dtype_of(cfg.compute_dtype)) \
        if cfg.n_aux_tokens else None
    with meshctx.use_mesh(counting({"data": 1, "model": 1})), collective_log() as log:
        model = Model(cfg, device="meta")
        with torch.no_grad():
            make_prefill_step(cfg, 16)(model, meta(2, 16), aux)
    assert any(k == "reduce-scatter" for k, _, _ in log)
