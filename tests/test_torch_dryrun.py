"""The port's dry-run without running, against the JAX reference: the
production meshes, the sharding rules as byte arithmetic, the optimizer
state's specs, the input specs, the ``meta`` FLOP and byte counter and the
``dryrun`` launcher; and the kernel wrappers on ``meta``.

The reference's rules run here on ``jax.sharding.AbstractMesh`` over the
production shapes, (16, 16) over ("data", "model") and (2, 16, 16) over
("pod", "data", "model"), with no devices: ``params_pspecs``, ``wrap``,
``bytes_per_device``, ``cache_shardings`` and ``opt_state_pspec`` over
``jax.eval_shape`` structs at full size. The port's per-device bytes must
equal the reference's exactly, and ``param_pspec`` match leaf for leaf.

The counter's products are held to the reference's trip-count-weighted
``weighted_dot_flops`` of the same step compiled here: both count 2 M N K a
product. The one gap is the head: the reference's prefill computes the
logits at every position and keeps the last, where the port's head runs at
the last position only, so the reference counts 2 B (S - 1) d V more.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import ARCH_IDS, INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch import steps as jsteps
from repro.launch.hloanalysis import weighted_dot_flops
from repro.models import sharding as jshd
from repro.optim.optimizers import make_optimizer as jmake_optimizer
from repro.optim.optimizers import opt_state_pspec as jopt_state_pspec
from repro_torch.configs import INPUT_SHAPES, InputShape, get_config, reduced
from repro_torch.kernels import (bottleneck, decode_attn, flat_trunk, pair_scorer, quant,
                                 ssd_intra)
from repro_torch.launch import dryrun, mesh as mesh_lib, opcount
from repro_torch.launch import steps
from repro_torch.models import cache as cache_lib, init_params
from repro_torch.models import sharding as shd
from repro_torch.optim.optimizers import opt_state_pspec, opt_state_structs

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# figures read from the reference: (params, optimizer, decode_32k cache) bytes a device
READ = {("qwen3-1.7b", "16x16"): (215_304_192, 861_216_772, 1_880_883_200),
        ("qwen3-1.7b", "2x16x16"): (215_304_192, 861_216_772, 940_441_600),
        ("qwen2-7b", "16x16"): (952_335_104, 3_809_340_420, 941_359_104),
        ("kimi-k2-1t-a32b", "16x16"): (8_205_395_968, 45_364_716, 4_097_638_400),
        ("kimi-k2-1t-a32b", "2x16x16"): (8_205_395_968, 45_364_716, 2_048_819_200),
        ("llama-3.2-vision-90b", "16x16"): (688_177_192, 4_474_356, 5_439_488_000)}


def _meshes(label):
    sizes, names = MESHES[label]
    return AbstractMesh(sizes, names), mesh_lib.Mesh(names, sizes)


def _key(path):
    """A jax tree path as the port's path tuple."""
    out = []
    for p in path:
        if hasattr(p, "key"):
            out.append(p.key)
        elif hasattr(p, "idx"):
            out.append(p.idx)
        else:
            raise TypeError(p)
    return tuple(out)


def _by_path(tree, is_leaf=None):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {_key(path): leaf for path, leaf in leaves}


def _norm(spec):
    """A spec with one-name tuples written as the name, as ``PartitionSpec``
    normalises them."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _specs(tree):
    return {k: _norm(v) for k, v in _by_path(tree, lambda x: isinstance(x, P)).items()}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's params and optimizer-state structs of ``arch``."""
    cfg = jget_config(arch)
    pstruct = jsteps.params_spec(cfg)
    return cfg, pstruct, jax.eval_shape(jmake_optimizer(cfg.optimizer)[0], pstruct)


@functools.lru_cache(maxsize=None)
def _port(arch):
    cfg = get_config(arch)
    return cfg, shd.reference_params(steps.params_spec(cfg))


def _dtype(x):
    return str(x).replace("torch.", "") if isinstance(x, torch.dtype) else np.dtype(x).name


# ------------------------------------------------------------------ meshes
def test_production_and_host_meshes():
    for multi_pod, label in ((False, "16x16"), (True, "2x16x16")):
        m = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        sizes, names = MESHES[label]
        assert (m.axis_names, m.axis_sizes, m.label, m.size) == (names, sizes, label,
                                                                  int(np.prod(sizes)))
        assert m.shape == dict(AbstractMesh(sizes, names).shape)
        assert hash(m) == hash(mesh_lib.make_production_mesh(multi_pod=multi_pod))
    assert mesh_lib.make_host_mesh().shape == {"data": 1, "model": 1}   # no card here
    with pytest.raises(ValueError):
        mesh_lib.make_host_mesh(model_axis=2)


# ------------------------------------------------------ the sharding rules
@pytest.mark.parametrize("label", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bytes_per_device_equal_the_reference(arch, label):
    jcfg, pstruct, ostruct = _reference(arch)
    cfg, params = _port(arch)
    am, pm = _meshes(label)
    jpspecs = jshd.params_pspecs(am, pstruct, jcfg)
    pspecs = shd.params_pspecs(pm, params, cfg)
    want = {"params": jshd.bytes_per_device(pstruct, jshd.wrap(am, jpspecs)),
            "opt": jshd.bytes_per_device(ostruct, jshd.wrap(
                am, jopt_state_pspec(jcfg.optimizer, jpspecs)))}
    got = {"params": shd.bytes_per_device(params, pspecs, pm),
           "opt": shd.bytes_per_device(opt_state_structs(cfg.optimizer, params),
                                       opt_state_pspec(cfg.optimizer, pspecs), pm)}
    for shape in ("decode_32k", "long_500k"):
        jcache = jsteps.input_specs(jcfg, shape)["cache"]
        jcsh = jshd.cache_shardings(am, jcache, jcfg)
        want[shape] = jshd.bytes_per_device(jcache, jcsh)
        tree = shd.reference_cache(cfg, steps.input_specs(cfg, shape)["cache"])
        cspecs = shd.cache_pspecs(pm, tree, cfg)
        got[shape] = shd.bytes_per_device(tree, cspecs, pm)
        assert {k: _norm(v) for k, v in cspecs.items()} == {k: _norm(v.spec) for k, v in _by_path(
            jcsh, lambda x: isinstance(x, NamedSharding)).items()}, shape
    assert got == want
    if (arch, label) in READ:
        assert (got["params"], got["opt"], got["decode_32k"]) == READ[(arch, label)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference_leaf_for_leaf(arch):
    jcfg, pstruct, ostruct = _reference(arch)
    cfg, params = _port(arch)
    want_shapes = _by_path(pstruct)
    assert {k: (tuple(v.shape), _dtype(v.dtype)) for k, v in params.items()} == \
        {k: (tuple(v.shape), _dtype(v.dtype)) for k, v in want_shapes.items()}
    for label in MESHES:
        am, pm = _meshes(label)
        jspecs = jshd.params_pspecs(am, pstruct, jcfg)
        pspecs = shd.params_pspecs(pm, params, cfg)
        assert {k: _norm(v) for k, v in pspecs.items()} == _specs(jspecs), label
        # the optimizer state's specs and shapes, path by path
        ospecs = opt_state_pspec(cfg.optimizer, pspecs)
        jo = _specs(jopt_state_pspec(jcfg.optimizer, jspecs))
        structs = opt_state_structs(cfg.optimizer, params)
        jstructs = _by_path(ostruct)
        if cfg.optimizer == "adamw":
            assert {k: _norm(v) for k, v in ospecs.items()} == jo
            assert set(structs) == set(jstructs)
            for k, v in structs.items():
                assert (tuple(v.shape), _dtype(v.dtype)) == (tuple(jstructs[k].shape),
                                                            _dtype(jstructs[k].dtype)), k
        else:
            # the reference lists Adafactor's slots by leaf index, the port by path
            order = list(want_shapes)
            for k, v in ospecs.items():
                if k[0] == "slots":
                    jk = ("slots", order.index(k[1:-1]), k[-1])
                    assert _norm(v) == jo[jk] and tuple(structs[k].shape) == tuple(
                        jstructs[jk].shape), k
            assert len(ospecs) == len(jo) and ospecs[("step",)] == jo[("step",)] == ()
    moe = {k[-1] for k in params if k[-1] in ("wi", "wg", "wo") and params[k].dim() == 4}
    if cfg.moe is not None:
        assert moe == {"wi", "wg", "wo"}


def test_the_rules_reach_every_branch():
    """MoE experts, the RG-LRU ``wa``, the head-shared ``wbc`` and the
    biases take their rules' specs (the leaf-for-leaf test holds them to
    the reference's); an fsdp config shards the non-TP dim over data."""
    m = mesh_lib.make_production_mesh()
    got = {}
    for arch in ("kimi-k2-1t-a32b", "recurrentgemma-9b", "mamba2-1.3b", "qwen2-7b"):
        cfg, params = _port(arch)
        for path, spec in shd.params_pspecs(m, params, cfg).items():
            got.setdefault((arch, path[-1], params[path].dim()), spec)
    # kimi is an fsdp config: the experts' d dim also goes over data
    assert got[("kimi-k2-1t-a32b", "wi", 4)] == (None, "model", "data", None)
    assert got[("kimi-k2-1t-a32b", "wo", 4)] == (None, "model", None, "data")
    assert got[("recurrentgemma-9b", "wa", 3)] == (None, None, "model")
    assert got[("mamba2-1.3b", "wbc", 3)] == (None, None, None)
    assert got[("qwen2-7b", "bq", 2)] == (None, "model")
    cfg, params = _port("qwen2-7b")
    fsdp = shd.params_pspecs(m, params, cfg.replace(fsdp=True))
    jcfg, pstruct, _ = _reference("qwen2-7b")
    am, _ = _meshes("16x16")
    assert {k: _norm(v) for k, v in fsdp.items()} == _specs(
        jshd.params_pspecs(am, pstruct, jcfg.replace(fsdp=True)))
    assert fsdp[("embed",)] == ("model", "data")


def test_shard_shape_raises_on_an_indivisible_dim():
    am, pm = _meshes("2x16x16")
    assert shd.shard_shape((64, 30), (("pod", "data"), None), pm) == (2, 30)
    assert shd.shard_shape((64,), (), pm) == (64,)
    with pytest.raises(ValueError):
        NamedSharding(am, P("model")).shard_shape((30,))
    with pytest.raises(ValueError, match="not divisible"):
        shd.shard_shape((30,), ("model",), pm)
    with pytest.raises(ValueError, match="not divisible"):
        shd.shard_shape((16, 48), (("pod", "data"), None), pm)
    assert shd.batch_pspec(pm) == (("pod", "data"),)
    specs = shd.batch_pspecs(pm, {"t": steps.sds((64, 7), torch.int32),
                                  "odd": steps.sds((3, 7), torch.int32)})
    assert specs == {"t": (("pod", "data"), None), "odd": (None, None)}


# --------------------------------------------------------------- input specs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_the_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    assert set(INPUT_SHAPES) == set(J_INPUT_SHAPES)
    pattern_len = len(cfg.block_pattern)
    for name in INPUT_SHAPES:
        want = jsteps.input_specs(jcfg, name)
        got = steps.input_specs(cfg, name)
        assert steps.attn_len_for(cfg, INPUT_SHAPES[name]) == jsteps.attn_len_for(
            jcfg, J_INPUT_SHAPES[name])
        if "cache" in got:
            jcache = _by_path(want.pop("cache"))
            cache = got.pop("cache")
            tree = shd.reference_cache(cfg, cache)
            assert {k: (tuple(v.shape), _dtype(v.dtype)) for k, v in tree.items()} == \
                {("blocks",) + k[1:] if k[0] == "blocks" else k:
                 (tuple(v.shape), _dtype(v.dtype)) for k, v in jcache.items()}, name
            # group by group: layer g P + j of the port is group g of position j
            for (where, j, leaf), v in jcache.items():
                layers = (range(j, len(cache) - len(cache) % pattern_len, pattern_len)
                          if where == "blocks" else [len(cache) - len(cache) % pattern_len + j])
                for layer in layers:
                    t = cache[layer][leaf]
                    assert t.device.type == "meta"
                    assert tuple(t.shape) == tuple(v.shape[1:] if where == "blocks"
                                                   else v.shape), (name, layer, leaf)
        flat_got = _by_path(jax.tree_util.tree_map(lambda t: t, got))
        flat_want = _by_path(want)
        assert {k: (tuple(v.shape), _dtype(v.dtype)) for k, v in flat_got.items()} == \
            {k: (tuple(v.shape), _dtype(v.dtype)) for k, v in flat_want.items()}, name
        assert all(v.device.type == "meta" for v in flat_got.values())
    assert steps.long_context_applicable(cfg) == jsteps.long_context_applicable(jcfg)
    model = steps.params_spec(cfg)
    assert all(p.device.type == "meta" for p in model.parameters())


# ------------------------------------------------------------ the counter
@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_six_products_in_a_loop_count_each_time(device):
    """The counterpart of the reference's trip-count test: six 128 x 128
    products, each counted as it runs."""
    x = torch.ones((128, 128), device=device)
    ws = torch.ones((6, 128, 128), device=device)

    def scanned(x, ws):
        for w in ws:
            x = x @ w
        return x

    costs = opcount.op_costs(scanned, x, ws)
    assert costs["dot_flops"] == 2 * 128 ** 3 * 6
    assert costs["flops"] == 2 * 128 ** 3 * 6
    # each product reads two 64 kB operands and writes one; the slices are views
    assert costs["bytes_accessed"] == 6 * 3 * 128 * 128 * 4


def test_flops_are_the_flop_counters_total_and_bytes_skip_views():
    from torch.utils.flop_counter import FlopCounterMode
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn((2, 3, 16, 16), generator=g), torch.randn((8, 3, 3, 3), generator=g)
    m = torch.randn((8 * 14 * 14, 5), generator=g)

    def f(x, w, m):
        y = torch.nn.functional.conv2d(x, w).relu()
        return y.reshape(2, -1) @ m + torch.einsum("bi,bj->ij", y.reshape(2, -1), y.reshape(2, -1)).sum()

    with FlopCounterMode(display=False) as fc:
        f(x, w, m)
    for dev in ("cpu", "meta"):
        costs = opcount.op_costs(f, x.to(dev), w.to(dev), m.to(dev))
        assert costs["flops"] == fc.get_total_flops() > costs["dot_flops"] > 0
    assert opcount.op_costs(lambda t: t.view(-1).t().expand(3, -1), x)["bytes_accessed"] == 0
    assert opcount.op_costs(torch.add, x, x)["bytes_accessed"] == 3 * x.numel() * 4


def _tiny_dense():
    return jreduced(jget_config("qwen3-1.7b")), reduced(get_config("qwen3-1.7b"))


@pytest.mark.parametrize("b,s", [(2, 128), (2, 200)])
def test_prefill_dot_flops_equal_the_references_weighted_dot_flops(b, s):
    """Both sides count 2 M N K a product over the same layers and the same
    padded key chunks (s = 200 pads the last of four 64-key chunks); the
    reference also runs the head at the first s - 1 positions, which the
    port's prefill never forms. Tolerance: 1e-9 relative (float rounding of
    the sums only)."""
    jcfg, cfg = _tiny_dense()
    text = jax.jit(jsteps.make_prefill_step(jcfg, s)).lower(
        jsteps.params_spec(jcfg), jax.ShapeDtypeStruct((b, s), jnp.int32)).compile().as_text()
    want = weighted_dot_flops(text)
    with torch.no_grad():
        got = opcount.op_costs(steps.make_prefill_step(cfg, s), steps.params_spec(cfg),
                               steps.sds((b, s), torch.int32))["dot_flops"]
    head = 2 * b * (s - 1) * cfg.d_model * cfg.vocab_size
    assert got + head == pytest.approx(want, rel=1e-9)


def _warm_costs(fn, *args):
    """``op_costs`` of ``fn``'s second run: RoPE's inverse frequencies are
    built once a device (a copy to ``meta``, none on the CPU) and cached,
    so the first run's count depends on what ran before it."""
    opcount.op_costs(fn, *args)
    return opcount.op_costs(fn, *args)


def test_meta_counts_equal_counts_of_a_real_run():
    """The counter keeps ``meta`` result layouts by input layouts; the
    counts it gives are those of the same step run on real CPU tensors."""
    cfg = reduced(get_config("qwen3-1.7b"))
    step = steps.make_prefill_step(cfg, 80)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 80), generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    with torch.no_grad():
        real = _warm_costs(step, model, tokens)
        meta = _warm_costs(step, steps.params_spec(cfg), steps.sds((2, 80), torch.int32))
    assert real == meta


def _real_inputs(cfg, shape, specs, gen):
    """CPU tensors of ``specs``' shapes and dtypes: tokens drawn below the
    vocabulary, float leaves from N(0, 1), and a decode's cache as
    ``make_cache`` makes it."""
    if shape.kind == "decode":
        return {"cache": cache_lib.make_cache(cfg, shape.global_batch,
                                              steps.attn_len_for(cfg, shape), device="cpu"),
                "token": torch.randint(0, cfg.vocab_size, specs["token"].shape, generator=gen,
                                       dtype=specs["token"].dtype)}
    return {"batch": {k: torch.randint(0, cfg.vocab_size, v.shape, generator=gen, dtype=v.dtype)
                      if not v.is_floating_point()
                      else torch.randn(v.shape, generator=gen).to(v.dtype)
                      for k, v in specs["batch"].items()}}


@pytest.mark.parametrize("arch,kind,optimizer", [
    ("qwen3-1.7b", "train", "adamw"), ("qwen3-1.7b", "train", "adafactor"),
    ("mamba2-1.3b", "train", "adafactor"), ("qwen3-1.7b", "decode", None),
    ("mamba2-1.3b", "decode", None)])
def test_meta_counts_of_the_dry_runs_steps_equal_a_real_run(arch, kind, optimizer):
    """The dry-run's train steps (autograd, then the config's optimizer) and
    its decode steps, counted on ``meta`` with the cached result layouts,
    give the counts of the same step run on real CPU tensors."""
    cfg = reduced(get_config(arch), n_layers=2)
    if optimizer is not None:
        cfg = cfg.replace(optimizer=optimizer)
    shape = KINDS[kind]
    gen = torch.Generator().manual_seed(2)
    real_model = init_params(cfg, gen, "cpu")
    meta_specs = steps.input_specs(cfg, shape)
    real = _real_inputs(cfg, shape, meta_specs, gen)
    got = {}
    for where, model, inputs in (("cpu", real_model, real),
                                 ("meta", steps.params_spec(cfg), meta_specs)):
        if kind == "train":
            train_step, opt_init = steps.make_train_step(cfg)
            got[where] = _warm_costs(train_step, model, opt_init(model), inputs["batch"])
        else:
            with torch.no_grad():
                got[where] = _warm_costs(steps.make_serve_step(cfg), model, inputs["cache"],
                                         inputs["token"], shape.seq_len - 1)
    assert got["cpu"]["dot_flops"] > 0
    assert got["meta"] == got["cpu"]


# --------------------------------------------------------------- the dry-run
KINDS = {"train": InputShape("train_4k", 32, 4, "train"),
         "prefill": InputShape("prefill_32k", 48, 2, "prefill"),
         "decode": InputShape("decode_32k", 96, 4, "decode")}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b", "llama-3.2-vision-90b"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_run_one_records_every_key(monkeypatch, arch, kind):
    """A reduced config at a small shape of each kind of step."""
    shape = KINDS[kind]
    cfg = reduced(get_config(arch), n_layers=5 if arch.startswith("llama") else 2)
    monkeypatch.setattr(dryrun, "get_config", lambda name: cfg)
    monkeypatch.setattr(dryrun, "INPUT_SHAPES", {shape.name: shape})
    rec = dryrun.run_one(arch, shape.name, multi_pod=kind == "decode")
    held = "opt_bytes_per_device" if kind == "train" else "cache_bytes_per_device"
    assert set(rec) == {"arch", "shape", "mesh", "n_devices", "param_bytes_per_device", held,
                        "flops", "dot_flops", "bytes_accessed", "count_s", "collectives",
                        "memory_analysis", "notes"}
    assert rec["mesh"] == ("2x16x16" if kind == "decode" else "16x16")
    assert rec["n_devices"] == (512 if kind == "decode" else 256)
    for k in ("param_bytes_per_device", held, "flops", "dot_flops", "bytes_accessed"):
        assert rec[k] > 0, k
    assert rec["count_s"] >= 0
    assert rec["collectives"] is None and rec["memory_analysis"] is None
    assert set(rec["notes"]) == {"collectives", "memory_analysis"}
    json.dumps(rec)


def test_the_launcher_writes_records_and_reuses_counts(tmp_path):
    """``main`` counts mamba2-1.3b's long_500k decode once for both meshes
    and writes one JSON a mesh; a failing combination exits non-zero."""
    dryrun.counted.cache_clear()
    dryrun.main(["--arch", "mamba2-1.3b", "--shape", "long_500k", "--both-meshes",
                 "--out", str(tmp_path)])
    assert dryrun.counted.cache_info().misses == 1
    recs = [json.loads((tmp_path / f"mamba2-1.3b__long_500k__{p}.json").read_text())
            for p in ("pod1", "pod2")]
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert recs[0]["flops"] == recs[1]["flops"] > 0
    assert recs[0]["cache_bytes_per_device"] == recs[1]["cache_bytes_per_device"]  # batch 1
    dryrun.main(["--arch", "mamba2-1.3b", "--shape", "long_500k", "--skip-existing",
                 "--out", str(tmp_path)])
    with pytest.raises(SystemExit, match="1 dry-run combinations failed"):
        dryrun.main(["--arch", "no-such-arch", "--shape", "long_500k", "--out", str(tmp_path)])


# ------------------------------------------------- the kernel wrappers on meta
def _to(dev, *ts):
    return [t.to(dev) for t in ts]


def _wrapper_calls():
    """(name, call, CPU args) of each kernel wrapper."""
    g = torch.Generator().manual_seed(3)
    r = lambda *shape: torch.randn(shape, generator=g)
    codes = quant.quantize_plain(r(6, 5), -1.0, 1.0)
    ssd = [r(1, 2, 8, 2, 4), r(1, 2, 8, 2).abs(), -r(1, 2, 8, 2).abs(), r(1, 2, 8, 3),
           r(1, 2, 8, 3)]
    pos = torch.arange(16, dtype=torch.int32).expand(2, 16).contiguous()
    scorer = [r(5, 128), r(5).abs(), r(5).abs(), torch.ones(5), r(3, 3).abs(), r(8).abs(),
              r(4, 32), r(32), r(163, 48), r(48), r(48, 1), r(1)]
    tcodes = [quant.quantize_plain(r(19, 7), -1.0, 1.0), quant.quantize_plain(r(7, 4), -1.0, 1.0)]
    return [
        ("quantize", lambda x: quant.quantize_2d(x, -1.0, 1.0), [r(6, 5)]),
        ("dequantize", lambda y: quant.dequantize_2d(y, -1.0, 1.0), [codes]),
        ("bottleneck_encode", lambda x, w: bottleneck.bottleneck_encode(x, w, -1.0, 1.0),
         [r(6, 8), r(8, 2)]),
        ("ssd_intra", ssd_intra.ssd_intra, ssd),
        ("ssd_intra_backward", ssd_intra.ssd_intra_backward, [r(1, 2, 8, 2, 4)] + ssd),
        ("decode_attention", lambda q, k, v, p: decode_attn.decode_attention(q, k, v, p, 15),
         [r(2, 4, 8), r(2, 16, 2, 8), r(2, 16, 2, 8), pos]),
        ("pair_scorer", pair_scorer.pair_scorer, scorer),
        ("pair_scorer_backward",
         lambda gl, gs, *a: pair_scorer.pair_scorer_backward(gl, gs, *a, srv=None),
         [r(1, 5, 3), r(1, 3, 32)] + [t[None] if i < 5 else t for i, t in enumerate(scorer)]),
        ("flat_trunk", lambda x, c0, c1, b0, b1: flat_trunk.flat_trunk(
            x, [c0, c1], [-1.0, -1.0], [1.0, 1.0], [b0, b1]), [r(3, 19)] + tcodes + [r(7), r(4)]),
    ]


@pytest.mark.parametrize("name", [c[0] for c in _wrapper_calls()])
def test_wrappers_take_the_twins_shapes_on_meta(name):
    _, call, args = next(c for c in _wrapper_calls() if c[0] == name)
    want = call(*args)
    got = call(*_to("meta", *args))
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta" and g.shape == w.shape and g.dtype == w.dtype
    mixed = _to("meta", *args)
    mixed[-1] = args[-1]
    if len(args) > 1:
        with pytest.raises(ValueError, match="mix the meta device"):
            call(*mixed)
