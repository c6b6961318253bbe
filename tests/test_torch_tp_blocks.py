"""The tensor-parallel programs of the ``mamba2``, ``rec``, ``lattn``,
``enc``, ``decx`` and ``xattn`` blocks: serving and the train step of
mamba2-1.3b, recurrentgemma-9b, seamless-m4t-large-v2 and
llama-3.2-vision-90b as each rank of a process mesh runs them, over four
gloo ranks on the CPU.

Four reduced float32 configs, each pattern's block types present:
mamba2 (2 layers, 16 heads); recurrentgemma (rec, rec, lattn; one kv
head, which a model axis of 2 does not divide, so q, k and v are
gathered; a 32-slot ring, split 16 and 16, whose second run holds no
valid slot until the fourth decode step); seamless (2 encoder and 2 decx
layers; 3 heads, which the model axis does not divide, and a vocab of
511, which it does not divide either, so the embedding and the head stay
whole); llama-vision (its pattern cut to one dense and one xattn layer;
4 query on 2 kv heads, ``fsdp`` and Adafactor, its published settings). Every cross-attention
gate and the aux_embeds are drawn from a seed (the gates start at zero).

The reference's ``prefill``, ``decode_step`` (4 greedy steps) and
``make_train_step(cfg, warmup=0)`` (2 steps on a (4, 16) batch) are
jitted with its rules' shardings on a (2, 2) ("data", "model") host mesh
with ``AxisType.Auto`` axes, in two subprocesses with four forced host
devices each. The port's ranks are spawned once (``launch.mesh.spawn``); on a
(2, 2) mesh, and for seamless also on a (2, 1, 2) ("pod", "data",
"model") mesh, each loads the reference's draw cut to its blocks
(``weights.from_jax_params(..., mesh)``), serves its rows fed the
reference's tokens and trains on them, logging its collectives.

Held: prefill and decode logits within 1e-5 of max|logit| of one process
and of the reference; every rank's cache shard equal to one process's
cache cut by the rules (within 1e-5 of each leaf's largest; positions
exactly); each rank's collective logs, serving and training, equal to
the ``CountingMesh``'s on ``meta`` at its coordinates; the train metrics
within 1e-5 relative of one process and of the reference's partitioned
step; the parameters after step 2 within 0.1 x lr of both (the bound of
``tests/test_torch_sharded_train.py``). AdamW's first steps are about
lr g / |g| elementwise, so an element whose gradient is near zero, whose
sign the summation order decides, moves by up to lr either way a step.
Only such an element may lie past 0.1 x lr: at most ``PARAM_OUTLIERS`` of a
leaf of more than 2 elements, each within 4 x lr (two steps that each
move lr the other way) and each with a step-1 gradient (the reference's,
``jax.grad`` of its loss under the same shardings) within ``NEAR_ZERO`` of
its leaf's largest. recurrentgemma has two: a rec layer's ``wgate``
element lies 0.110 x lr from the reference (its gradient 3.6e-07 of the
leaf's largest; the leaf's median 5.2e-02) and a ``wx`` element lies
0.220 x lr from one process (1.0e-06; median 5.8e-02). The plain
``attention``'s new log-sum-exp is held to a float64 logsumexp, and
``merge_lse`` to the whole where one rank's run holds no valid slot.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.kernels import decode_attn
from repro_torch.launch.mesh import CountingMesh, Mesh, ProcessMesh, collective_log, spawn
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models import meshctx
from repro_torch.models import sharding as shd
from repro_torch.models.attention import attention, merge_lse
from repro_torch.models.model import Model
from repro_torch.weights import from_jax_params, reference_leaves

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x2": (("data", "model"), (2, 2)), "2x1x2": (("pod", "data", "model"), (2, 1, 2))}
# name: (arch, layers, overrides, prompt, cache slots)
CASES = {"mamba2": ("mamba2-1.3b", 2, {}, 12, 16),
         "rg": ("recurrentgemma-9b", 3, dict(window=32), 14, 18),
         "seamless": ("seamless-m4t-large-v2", 2,
                      dict(d_model=192, n_heads=3, n_kv_heads=3, d_head=64, d_ff=384,
                           vocab_size=511), 12, 16),
         "llama": ("llama-3.2-vision-90b", 5,
                   dict(n_layers=2, block_pattern=("dense", "xattn"), n_heads=4, n_kv_heads=2,
                        d_head=64, fsdp=True), 12, 16)}
ON_POD_MESH = ("seamless",)
BATCH, STEPS = 4, 4
SEQ, TRAIN_STEPS, LR = 16, 2, 3e-4
TOL = 1e-5            # logits x max|logit|; metrics relative; cache x the leaf's largest
PARAM_TOL = 0.1 * LR  # parameters after step 2, absolute
PARAM_OUTLIERS = 2    # elements of a leaf allowed past PARAM_TOL, each within 4 x lr,
NEAR_ZERO = 1e-5      # and each with a step-1 gradient within 1e-5 of the leaf's largest
METRICS = ("loss", "ce", "aux", "grad_norm")

_SCRIPT = r"""
import pickle, sys
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
    cfg = reduced(get_config(arch), n_layers=layers).replace(**kw)
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
    p1, s1, m1 = step(*args)
    p2, _, m2 = step(p1, s1, args[2])
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
    out[name] = {"params": np_(params), "tokens": np.asarray(tokens),
                 "aux": None if aux is None else np.asarray(aux),
                 "prefill": np.asarray(logits), "fed": np.concatenate(fed, 1),
                 "decode": np.stack(outs), "params2": np_(p2), "grads1": np_(g1),
                 "metrics": [{k: float(v) for k, v in m.items()} for m in (m1, m2)]}
pickle.dump(out, open(sys.argv[1], "wb"))
print("REF_OK")
"""


def cfg_of(name):
    arch, layers, kw, _, _ = CASES[name]
    return reduced(get_config(arch), n_layers=layers).replace(**kw)


def the_batch():
    """(4, 16) tokens and their next-token labels, some ignored."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 511, (BATCH, SEQ), dtype=np.int64)
    labels = np.roll(tokens, -1, 1)
    labels[:, -1] = -100
    labels[0, :3] = -100
    return {"tokens": tokens, "labels": labels}


def rows_of(mesh, n=BATCH):
    b = n // meshctx.dp_size(mesh)
    i = mesh.index(meshctx.dp_axes(mesh))
    return slice(i * b, (i + 1) * b)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


@torch.no_grad()
def serve_steps(model, cfg, tokens, aux, fed, slots):
    """Prefill ``tokens`` (with ``aux`` embeddings where the arch reads
    them), then one decode step a column of ``fed``: (the prefill's logits,
    each step's, the cache, the prefill's collective log, the steps')."""
    with collective_log() as pre_log:
        logits, cache = make_prefill_step(cfg, slots)(model, tokens, aux)
    step = make_serve_step(cfg)
    outs = []
    with collective_log() as dec_log:
        for i in range(fed.shape[1]):
            out, cache = step(model, cache, fed[:, i:i + 1], tokens.shape[1] + i)
            outs.append(out)
    return logits, torch.stack(outs), cache, list(pre_log), list(dec_log)


def train_steps(model, cfg, batch):
    """``TRAIN_STEPS`` train steps: (each step's metrics, the parameters
    after the last, each step's collective log)."""
    train_step, opt_init = make_train_step(cfg, base_lr=LR, warmup=0)
    state = opt_init(model)
    metrics, logs = [], []
    for _ in range(TRAIN_STEPS):
        with collective_log() as log:
            model, state, m = train_step(model, state, batch)
        metrics.append({k: float(v) for k, v in m.items()} if m["loss"].device.type != "meta"
                       else {})
        logs.append(list(log))
    return metrics, [p.detach().clone() for p in model.parameters()], logs


def case_inputs(r, rows=slice(None)):
    """The serve's tokens, aux_embeds and fed tokens, and the train batch,
    of a reference case, at ``rows``."""
    batch = {k: torch.from_numpy(v[rows]) for k, v in the_batch().items()}
    aux = _t(r["aux"])
    if aux is not None:
        batch["aux_embeds"] = aux[rows]
        aux = aux[rows]
    return (_t(r["tokens"][rows]).long(), aux, _t(r["fed"][rows]).long(), batch)


def lse_inputs(empty_half):
    """A decode call's inputs over 24 slots (float): with ``empty_half``
    the second half of every row holds no valid slot, else one row is
    empty. (q, k, v, pos, idx)."""
    g = torch.Generator().manual_seed(7)
    b, s, hkv, grp, d = 3, 24, 2, 3, 32
    q = torch.randn((b, hkv * grp, d), generator=g)
    k, v = torch.randn((b, s, hkv, d), generator=g), torch.randn((b, s, hkv, d), generator=g)
    pos = torch.arange(s, dtype=torch.int32).repeat(b, 1)
    if empty_half:
        pos[:, s // 2:] = -1
    else:
        pos[2] = -1
    return q, k, v, pos, s - 3


def _rank(rank, device, ref):
    meshes = {name: ProcessMesh(*spec) for name, spec in MESHES.items()}
    out = {"coords": {name: {a: m.index(a) for a in m.axis_names} for name, m in meshes.items()}}
    for mname, mesh in meshes.items():
        for name, r in ref.items():
            if mname != "2x2" and name not in ON_POD_MESH:
                continue
            cfg = cfg_of(name)
            tokens, aux, fed, batch = case_inputs(r, rows_of(mesh))
            with meshctx.use_mesh(mesh):
                model = from_jax_params(r["params"], cfg, "cpu", mesh)
                serve = serve_steps(model, cfg, tokens, aux, fed, CASES[name][4])
                model = from_jax_params(r["params"], cfg, "cpu", mesh)
                out[(mname, name)] = serve + train_steps(model, cfg, batch)
    # two ranks' halves of a decode's cache, the second holding no valid
    # slot, merged through the kernel's and the plain attention's lse
    mesh = meshes["2x2"]
    q, k, v, pos, idx = lse_inputs(empty_half=True)
    half = shd.block_of(k.shape[1], "model", mesh)
    o, lse = decode_attn.decode_attention(q, k[:, half], v[:, half], pos[:, half].contiguous(),
                                          idx, return_lse=True)
    out["merge_kernel"] = merge_lse(o, lse, mesh)
    b, hq, d = q.shape
    o, lse = attention(q[:, None], k[:, half], v[:, half],
                       q_positions=torch.full((b, 1), idx, dtype=torch.int32),
                       k_positions=pos[:, half], chunk=8, return_lse=True)
    out["merge_plain"] = merge_lse(o[:, 0], lse[:, 0], mesh)
    return out


# the reference's cases in two subprocesses run side by side (its compiles take the time)
REF_JOBS = (("mamba2", "seamless"), ("rg", "llama"))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tpb")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    jobs = []
    for i, names in enumerate(REF_JOBS):
        script = _SCRIPT % {"cases": {n: CASES[n] for n in names}, "batch": BATCH,
                            "steps": STEPS, "lr": LR,
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
    return {name: out[name] for name in CASES}


@pytest.fixture(scope="module")
def ranks(ref):
    light = {name: {k: r[k] for k in ("params", "tokens", "aux", "fed")}
             for name, r in ref.items()}
    return spawn(_rank, 4, "gloo", light, device="cpu")


@pytest.fixture(scope="module")
def one(ref):
    """Each case in one process, no mesh, fed the reference's tokens."""
    out = {}
    for name, r in ref.items():
        cfg = cfg_of(name)
        tokens, aux, fed, batch = case_inputs(r)
        serve = serve_steps(from_jax_params(r["params"], cfg, "cpu"), cfg, tokens, aux, fed,
                            CASES[name][4])
        out[name] = serve + train_steps(from_jax_params(r["params"], cfg, "cpu"), cfg, batch)
    return out


def counting(mname, coords):
    return CountingMesh(Mesh(*MESHES[mname]), coords)


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


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def rel_scalar(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


CASE_IDS = [("2x2", n) for n in CASES] + [("2x1x2", n) for n in ON_POD_MESH]
IDS = [f"{m}-{n}" for m, n in CASE_IDS]


@pytest.mark.parametrize("mname,name", CASE_IDS, ids=IDS)
def test_prefill_logits_equal_one_process(ranks, one, mname, name):
    assert rel(gathered(ranks, mname, name, 0), one[name][0]) <= TOL


@pytest.mark.parametrize("mname,name", CASE_IDS, ids=IDS)
def test_decode_logits_equal_one_process(ranks, one, mname, name):
    assert rel(gathered(ranks, mname, name, 1), one[name][1]) <= TOL


@pytest.mark.parametrize("name", CASES)
def test_logits_equal_the_references_partitioned_steps(ref, ranks, name):
    r = ref[name]
    assert rel(gathered(ranks, "2x2", name, 0), torch.from_numpy(r["prefill"])) <= TOL
    assert rel(gathered(ranks, "2x2", name, 1), torch.from_numpy(r["decode"])) <= TOL


@pytest.mark.parametrize("mname,name", CASE_IDS, ids=IDS)
def test_cache_shards_are_one_process_cache_cut(ranks, one, mname, name):
    cfg = cfg_of(name)
    for r in ranks:
        mesh = counting(mname, r["coords"][mname])
        want = shd.cut_cache(one[name][2], mesh)
        got = r[(mname, name)][2]
        assert len(got) == len(want) == cfg.n_layers
        for e_got, e_want in zip(got, want):
            assert sorted(e_got) == sorted(e_want)
            for leaf, t in e_want.items():
                assert e_got[leaf].shape == t.shape, leaf
                if leaf == "pos":
                    assert torch.equal(e_got[leaf], t)
                else:
                    assert float((e_got[leaf] - t).abs().max()) <= TOL * float(t.abs().max()), \
                        leaf
    # the states and the context cache are cut by the rules: heads, channels, length
    e = ranks[0][(mname, name)][2][-1]
    if name == "mamba2":
        assert e["h"].shape[1] == 16 // 2 and e["conv_x"].shape[2] == 512 // 2
        assert e["conv_bc"].shape[2] == 2 * cfg.ssm.d_state
    if name == "rg":
        assert e["k"].shape[1] == 32 // 2 and ranks[0][(mname, name)][2][0]["h"].shape[1] == 128
    if name in ("seamless", "llama"):
        assert e["ck"].shape[1:3] == (16 // 2, cfg.n_kv_heads)


@pytest.mark.parametrize("mname,name", CASE_IDS, ids=IDS)
def test_serve_collective_log_equals_the_counting_mesh(ref, ranks, mname, name):
    cfg = cfg_of(name)
    r0 = ref[name]
    for r in ranks:
        mesh = counting(mname, r["coords"][mname])
        rows = rows_of(mesh)
        meta = lambda a, dt=torch.long: torch.empty(a[rows].shape, dtype=dt, device="meta")
        aux = None if r0["aux"] is None else meta(r0["aux"], torch.float32)
        with meshctx.use_mesh(mesh):
            model = Model(cfg, device="meta")
            *_, pre_log, dec_log = serve_steps(model, cfg, meta(r0["tokens"]), aux,
                                               meta(r0["fed"]), CASES[name][4])
        assert r[(mname, name)][3] == pre_log
        assert r[(mname, name)][4] == dec_log
        # mamba2's residual is sequence-parallel at prefill (seq_parallel_residual, a
        # prompt the model axis divides): its out_proj reduce-scatters along the sequence
        seq = {"reduce-scatter"} if cfg.seq_parallel_residual else set()
        assert {k for k, _, _ in pre_log} == {"all-gather", "all-reduce"} | seq


@pytest.mark.parametrize("mname,name", CASE_IDS, ids=IDS)
def test_train_metrics_equal_one_process_and_the_reference(ref, ranks, one, mname, name):
    for r in ranks:
        got = r[(mname, name)][5]
        for step in range(TRAIN_STEPS):
            for k in METRICS:
                assert rel_scalar(got[step][k], ref[name]["metrics"][step][k]) <= TOL, (step, k)
                assert rel_scalar(got[step][k], one[name][5][step][k]) <= TOL, (step, k)


@pytest.mark.parametrize("mname,name", CASE_IDS, ids=IDS)
def test_parameters_after_step_two(ref, ranks, one, mname, name):
    cfg = cfg_of(name)
    for r in ranks:
        mesh = counting(mname, r["coords"][mname])
        with meshctx.use_mesh(mesh):
            specs = Model(cfg, device="meta")
        params = list(specs.parameters())
        got = r[(mname, name)][6]
        for leaf in reference_leaves(specs):
            a = np.asarray(_at(ref[name]["params2"], leaf.path))
            for gi, i in enumerate(leaf.index):
                want = torch.from_numpy(np.asarray(a[gi] if leaf.stacked else a))
                gr = np.asarray(_at(ref[name]["grads1"], leaf.path))
                g = torch.from_numpy(np.asarray(gr[gi] if leaf.stacked else gr))
                cut = lambda t: shd.cut(t, params[i].spec, mesh)
                # each element's step-1 gradient over the leaf's largest (the reference's)
                near = cut(g).abs() / g.abs().max()
                for w in (want, one[name][6][i]):
                    gap = (got[i] - cut(w)).abs()
                    past = gap > PARAM_TOL
                    if past.any():
                        assert want.numel() > 2, (leaf.path, float(gap.max()) / LR)
                        assert int(past.sum()) <= PARAM_OUTLIERS, leaf.path
                        assert float(near[past].max()) <= NEAR_ZERO, (leaf.path, near[past])
                        assert float(gap.max()) <= 4 * LR, leaf.path


@pytest.mark.parametrize("mname,name", CASE_IDS, ids=IDS)
def test_train_collective_log_equals_the_counting_mesh(ranks, mname, name):
    cfg = cfg_of(name)
    batch = the_batch()
    for r in ranks:
        mesh = counting(mname, r["coords"][mname])
        rows = rows_of(mesh)
        meta = {k: torch.empty(v[rows].shape, dtype=torch.long, device="meta")
                for k, v in batch.items()}
        if cfg.n_aux_tokens:
            meta["aux_embeds"] = torch.empty((rows.stop - rows.start, cfg.n_aux_tokens,
                                              cfg.d_model), device="meta")
        with meshctx.use_mesh(mesh):
            logs = train_steps(Model(cfg, device="meta"), cfg, meta)[2]
        assert r[(mname, name)][7] == logs
        assert {"all-gather", "all-reduce"} <= {k for k, _, _ in logs[0]}


@pytest.mark.parametrize("which", ["kernel", "plain"])
def test_merge_lse_weighs_a_run_with_no_valid_slot_as_nothing(ranks, which):
    q, k, v, pos, idx = lse_inputs(empty_half=True)
    whole = decode_attn.decode_attention(q, k, v, pos, idx)
    for r in ranks:
        got = r["merge_" + which]
        assert torch.isfinite(got).all()
        assert float((got - whole).abs().max()) <= 1e-5 * float(whole.abs().max())


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_plain_attention_lse_is_the_float64_logsumexp(causal, window):
    g = torch.Generator().manual_seed(11)
    b, sq, sk, hkv, grp, d = 2, 6, 20, 2, 2, 32
    q = torch.randn((b, sq, hkv * grp, d), generator=g)
    k, v = torch.randn((b, sk, hkv, d), generator=g), torch.randn((b, sk, hkv, d), generator=g)
    qpos = torch.arange(sk - sq, sk, dtype=torch.int32).repeat(b, 1)
    kpos = torch.arange(sk, dtype=torch.int32).repeat(b, 1)
    kpos[1, 15:] = -1
    kw = dict(q_positions=qpos, k_positions=kpos, causal=causal, window=window, chunk=8)
    o, lse = attention(q, k, v, return_lse=True, **kw)
    assert o.dtype == torch.float32 and lse.shape == (b, sq, hkv * grp)
    assert torch.allclose(o, attention(q, k, v, **kw), rtol=0, atol=0)
    s = torch.einsum("bqhgd,bkhd->bqhgk", q.double().reshape(b, sq, hkv, grp, d) * d ** -0.5,
                     k.double())
    valid = kpos[:, None, :] >= 0
    if causal:
        valid = valid & (kpos[:, None, :] <= qpos[:, :, None])
    if window:
        valid = valid & (kpos[:, None, :] > qpos[:, :, None] - window)
    s = torch.where(valid[:, :, None, None, :], s, -1e30)
    want = torch.logsumexp(s, -1).reshape(b, sq, hkv * grp)
    assert float((lse.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_plain_attention_lse_of_a_row_with_no_valid_key_is_minus_1e30():
    q, k, v = torch.ones((1, 1, 2, 8)), torch.ones((1, 4, 1, 8)), torch.ones((1, 4, 1, 8))
    _, lse = attention(q, k, v, q_positions=torch.zeros((1, 1), dtype=torch.int32),
                       k_positions=torch.full((1, 4), -1, dtype=torch.int32), return_lse=True)
    assert torch.all(lse == torch.tensor(-1e30, dtype=torch.float32))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_builds_under_a_cutting_mesh(arch):
    """At its published widths, on meta: every block type has a program,
    and the mesh cuts some leaf of every block."""
    cfg = get_config(arch)
    with meshctx.use_mesh(counting("2x2", {"data": 1, "model": 1})):
        model = Model(cfg, device="meta")
    for blk in list(model.blocks) + (list(model.encoder.blocks) if model.encoder else []):
        assert any("model" in (p.spec or ()) for p in blk.parameters()), type(blk).__name__


def test_rules_cut_the_new_leaves():
    mesh = counting("2x2", {"data": 1, "model": 1})
    with meshctx.use_mesh(mesh):
        mamba = Model(cfg_of("mamba2"), device="meta").blocks[0].mixer
        rg = Model(cfg_of("rg"), device="meta").blocks[0].mixer
        llama = Model(cfg_of("llama"), device="meta").blocks[1].xattn
    assert mamba.wx.spec == (None, "model") and mamba.wdt.spec == (None, "model")
    assert mamba.conv_x.spec == (None, "model") and mamba.conv_x_b.spec == ("model",)
    assert mamba.wbc.spec == (None, None) and mamba.A_log.spec == (None,)
    assert mamba.norm_scale.shape == (512,) and mamba.out_proj.spec == ("model", None)
    assert rg.wa.spec == (None, "model") and rg.wi.spec == (None, "model")
    assert rg.conv_w.spec == (None, "model") and rg.lam.shape == (256,)
    assert rg.out.spec == ("model", None)
    assert llama.wq.spec == ("data", "model") and llama.wo.spec == ("model", "data")
    assert llama.gate.spec == ()


def test_a_mamba2_mixer_whose_heads_do_not_split_raises():
    """d_inner 96 splits over a model axis of 2; its 3 heads do not."""
    cfg = reduced(get_config("mamba2-1.3b"), n_layers=1, d_model=48)
    assert cfg.d_model * cfg.ssm.expand // cfg.ssm.head_dim == 3
    mesh = counting("2x2", {})
    with meshctx.use_mesh(mesh), pytest.raises(ValueError, match="heads"):
        make_prefill_step(cfg, 8)(Model(cfg, device="meta"),
                                  torch.empty((2, 8), dtype=torch.long, device="meta"))
