"""The dry-run's collectives and memory (``launch.dryrun``), counted from
the program rank 0 of a mesh runs on ``meta`` under a ``CountingMesh``,
against the reference's partitioned steps.

The reference's prefill and decode steps of reduced configs are jitted
with its rules' ``in_shardings`` / ``out_shardings`` (as its dry-run's
``build_lowered`` makes them) on a (2, 2) ("data", "model") host mesh with
``AxisType.Auto`` axes (jax 0.9.0's ``make_mesh`` gives ``Explicit``
axes, under which the reference's ``wsc_batch`` refuses to trace), and
compiled in a subprocess with four forced host devices; its
``memory_analysis`` and ``hloanalysis.analyze``'s collectives are read
there. The port's ``counted_rank`` runs the same steps on ``meta`` at the
same mesh: its argument and output bytes must equal the reference's
exactly, and its ``moved_bytes`` must be within ``MOVED_FACTOR`` of them
(GSPMD picks its own collectives: all-to-alls and permutes where the port
gathers; measured within 1.233 at these configs).

The other block types' programs (``mamba2``, ``rec``, ``lattn``, ``enc``,
``decx``, ``xattn``) are counted the same way for reduced mamba2-1.3b,
recurrentgemma-9b, seamless-m4t-large-v2 and llama-3.2-vision-90b (its
pattern cut to one dense and one xattn layer), prefill, decode and train,
beside the reference's compiled steps in a second subprocess run at the
same time: their argument and output bytes are held to the reference's
exactly at prefill and decode; their moved bytes are printed beside the
reference's (``PERF.md``'s moved-bytes table) and held only to be
positive, as ``tests/test_torch_sharded_train.py`` holds its train steps'.
mamba2's residual is sequence-parallel in train and prefill
(``seq_parallel_residual``) in both programs: the port reduce-scatters each
layer's ``out_proj`` along the sequence and all-gathers the next layer's
input (``tests/test_torch_seq_parallel.py``); the reference's compiled
program keeps its all-reduces and adds all-gathers, all-to-alls and
collective-permutes around them, which the case "mamba2off" (the flag
off in both packages) shows beside it.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch.hloanalysis import _moved_bytes
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import CountingMesh, Mesh, collectives_record, moved_bytes

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

ROOT = Path(__file__).resolve().parents[1]
MOVED_FACTOR = 1.25
# name: (arch, overrides, MoE capacity factor)
CASES = {"qwen2": ("qwen2-7b", dict(n_heads=4, n_kv_heads=2, d_head=64), None),
         "qwen3": ("qwen3-1.7b", {}, None),
         "kv8": ("qwen2-7b-kv8", dict(n_heads=4, n_kv_heads=2, d_head=64), None),
         "moe": ("qwen3-moe-30b-a3b", dict(n_heads=4, n_kv_heads=2, d_head=64, fsdp=True), 8.0)}
KINDS = ("prefill", "decode")
SHAPE = dict(seq=64, batch=4)
# the other block types' archs: (arch, layers, overrides); prefill, decode and train
BLOCK_CASES = {"mamba2": ("mamba2-1.3b", 2, {}),
               "mamba2off": ("mamba2-1.3b", 2, dict(seq_parallel_residual=False)),
               "rg": ("recurrentgemma-9b", 3, {}),
               "seamless": ("seamless-m4t-large-v2", 2, {}),
               "llama": ("llama-3.2-vision-90b", 5,
                         dict(n_layers=2, block_pattern=("dense", "xattn"), n_heads=4,
                              n_kv_heads=2, d_head=64, fsdp=True))}
BLOCK_KINDS = ("prefill", "decode", "train")

_SCRIPT = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config, reduced
from repro.launch import hloanalysis, steps
from repro.models import cache as jcache, meshctx, sharding as shd

from repro.optim.optimizers import opt_state_pspec

CASES = %(cases)r
B, S = %(batch)d, %(seq)d
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
meshctx.set_mesh(mesh)
out = {}
for name, (arch, layers, kw, cf, kinds) in CASES.items():
    cfg = reduced(get_config(arch), n_layers=layers).replace(**kw)
    if cf:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    pstruct = steps.params_spec(cfg)
    psh = shd.params_shardings(mesh, pstruct, cfg)
    batch = lambda t: shd.batch_shardings(mesh, {"t": t})["t"]
    aux = (jax.ShapeDtypeStruct((B, cfg.n_aux_tokens, cfg.d_model), jnp.float32)
           if cfg.n_aux_tokens else None)
    for kind in kinds:
        if kind == "prefill":
            tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
            step = steps.make_prefill_step(cfg, S)
            inputs = (tok,) if aux is None else (tok, aux)
            lst, cst = jax.eval_shape(step, pstruct, *inputs)
            fn = jax.jit(step, in_shardings=(psh,) + tuple(batch(t) for t in inputs),
                         out_shardings=(batch(lst), shd.cache_shardings(mesh, cst, cfg)))
            args = (pstruct,) + inputs
        elif kind == "train":
            tb = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
                  "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
            if aux is not None:
                tb["aux_embeds"] = aux
            step, opt_init = steps.make_train_step(cfg)
            ostruct = jax.eval_shape(opt_init, pstruct)
            pspecs = shd.params_pspecs(mesh, pstruct, cfg)
            shard = (shd.wrap(mesh, pspecs),
                     shd.wrap(mesh, opt_state_pspec(cfg.optimizer, pspecs)),
                     shd.batch_shardings(mesh, tb))
            mstruct = jax.eval_shape(step, pstruct, ostruct, tb)[2]
            msh = jax.tree_util.tree_map(lambda _: NamedSharding(mesh, P()), mstruct)
            fn = jax.jit(step, in_shardings=shard, out_shardings=shard[:2] + (msh,))
            args = (pstruct, ostruct, tb)
        else:
            cache = jcache.make_cache(cfg, B, S, leaf_fn=jax.ShapeDtypeStruct)
            tok = jax.ShapeDtypeStruct((B, 1), jnp.int32)
            idx = jax.ShapeDtypeStruct((), jnp.int32)
            step = steps.make_serve_step(cfg)
            lst, _ = jax.eval_shape(step, pstruct, cache, tok, idx)
            csh = shd.cache_shardings(mesh, cache, cfg)
            fn = jax.jit(step, in_shardings=(psh, csh, batch(tok), NamedSharding(mesh, P())),
                         out_shardings=(batch(lst), csh))
            args = (pstruct, cache, tok, idx)
        compiled = fn.lower(*args).compile()
        ma = compiled.memory_analysis()
        out[f"{name}_{kind}"] = {
            "argument_size_in_bytes": int(ma.argument_size_in_bytes),
            "output_size_in_bytes": int(ma.output_size_in_bytes),
            "collectives": hloanalysis.analyze(compiled.as_text())["collectives"]}
json.dump(out, open(sys.argv[1], "w"))
print("REF_OK")
"""


def cfg_of(name):
    if name in BLOCK_CASES:
        arch, layers, kw = BLOCK_CASES[name]
        return reduced(get_config(arch), n_layers=layers).replace(**kw)
    arch, kw, cf = CASES[name]
    cfg = reduced(get_config(arch), n_layers=2).replace(**kw)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf)) if cf else cfg


def shape_of(kind):
    return InputShape(kind, SHAPE["seq"], SHAPE["batch"], kind)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's compiled steps: the dense and MoE cases and the
    other block types' cases in two subprocesses side by side."""
    tmp = tmp_path_factory.mktemp("dry")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    jobs = ({n: (a, 2, kw, cf, KINDS) for n, (a, kw, cf) in CASES.items()},
            {n: (a, layers, kw, None, BLOCK_KINDS) for n, (a, layers, kw) in BLOCK_CASES.items()})
    procs = []
    for i, cases in enumerate(jobs):
        script = _SCRIPT % {"cases": cases, "batch": SHAPE["batch"], "seq": SHAPE["seq"]}
        procs.append((tmp / f"ref{i}.json", subprocess.Popen(
            [sys.executable, "-c", script, str(tmp / f"ref{i}.json")], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    out = {}
    for path, proc in procs:
        stdout, stderr = proc.communicate(timeout=600)
        assert "REF_OK" in stdout, stdout + stderr
        out.update(json.loads(path.read_text()))
    return out


@pytest.fixture(scope="module")
def port():
    mesh = Mesh(("data", "model"), (2, 2))
    cases = [(n, k) for n in CASES for k in KINDS] + [(n, k) for n in BLOCK_CASES
                                                      for k in BLOCK_KINDS]
    return {f"{name}_{kind}": dryrun.counted_rank(cfg_of(name), shape_of(kind), mesh)
            for name, kind in cases}


CASE_IDS = [f"{n}-{k}" for n in CASES for k in KINDS]


@pytest.mark.parametrize("key", ["argument_size_in_bytes", "output_size_in_bytes"])
@pytest.mark.parametrize("case", CASE_IDS)
def test_bytes_equal_the_references_memory_analysis(ref, port, case, key):
    name, kind = case.split("-")
    assert port[f"{name}_{kind}"][1][key] == ref[f"{name}_{kind}"][key]


@pytest.mark.parametrize("case", CASE_IDS)
def test_moved_bytes_within_a_factor_of_the_references(ref, port, case):
    name, kind = case.split("-")
    got = port[f"{name}_{kind}"][0]
    want = ref[f"{name}_{kind}"]["collectives"]
    kinds = sorted({k for k in list(got) + list(want) if not k.endswith("_count")
                    and k != "moved_bytes"})
    print(f"{case}: moved_bytes port {got['moved_bytes']:.0f}, reference "
          f"{want['moved_bytes']:.0f}; by kind (bytes, count) port "
          f"{ {k: (got.get(k, 0), got.get(k + '_count', 0)) for k in kinds} } reference "
          f"{ {k: (want.get(k, 0), want.get(k + '_count', 0)) for k in kinds} }")
    ratio = got["moved_bytes"] / want["moved_bytes"]
    assert 1 / MOVED_FACTOR <= ratio <= MOVED_FACTOR


BLOCK_IDS = [f"{n}-{k}" for n in BLOCK_CASES for k in BLOCK_KINDS]


@pytest.mark.parametrize("key", ["argument_size_in_bytes", "output_size_in_bytes"])
@pytest.mark.parametrize("case", [c for c in BLOCK_IDS if not c.endswith("train")])
def test_other_blocks_bytes_equal_the_references_memory_analysis(ref, port, case, key):
    name, kind = case.split("-")
    assert port[f"{name}_{kind}"][1][key] == ref[f"{name}_{kind}"][key]


@pytest.mark.parametrize("case", BLOCK_IDS)
def test_other_blocks_moved_bytes_beside_the_references(ref, port, case):
    """Reported, not held (PERF.md's moved-bytes table): GSPMD picks its
    own collectives; at mamba2's sequence-parallel residual (train and
    prefill) it keeps the all-reduces and re-lays the residual out around
    them, where the port reduce-scatters and all-gathers ("mamba2off" is
    the same arch with ``seq_parallel_residual`` off)."""
    name, kind = case.split("-")
    got = port[f"{name}_{kind}"][0]
    want = ref[f"{name}_{kind}"]["collectives"]
    kinds = sorted({k for k in list(got) + list(want) if not k.endswith("_count")
                    and k != "moved_bytes"})
    print(f"{case}: moved_bytes port {got['moved_bytes']:.0f}, reference "
          f"{want['moved_bytes']:.0f} (ratio {got['moved_bytes'] / want['moved_bytes']:.3f}); "
          f"by kind (bytes, count) port "
          f"{ {k: (got.get(k, 0), got.get(k + '_count', 0)) for k in kinds} } reference "
          f"{ {k: (want.get(k, 0), want.get(k + '_count', 0)) for k in kinds} }")
    assert got["moved_bytes"] > 0 and want["moved_bytes"] > 0


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_the_references_sequence_parallel_residual_keeps_its_all_reduces(ref, port, kind):
    """With ``seq_parallel_residual`` the reference's compiled step keeps
    the all-reduce bytes of its flag-off program (prefill: the same; train:
    more), reduce-scatters nothing, and moves more (its re-layouts); the
    port's program turns each layer's all-reduce into an all-gather and a
    reduce-scatter."""
    on, off = ref[f"mamba2_{kind}"]["collectives"], ref[f"mamba2off_{kind}"]["collectives"]
    print(f"reference mamba2 {kind}: moved bytes with the flag {on['moved_bytes']:.0f}, without "
          f"{off['moved_bytes']:.0f}; all-reduce bytes {on.get('all-reduce')} / "
          f"{off.get('all-reduce')}")
    assert on["all-reduce"] >= off["all-reduce"]
    assert "reduce-scatter" not in on and on["moved_bytes"] > off["moved_bytes"]
    assert port[f"mamba2_{kind}"][0].get("reduce-scatter", 0) > \
        port[f"mamba2off_{kind}"][0].get("reduce-scatter", 0)


@pytest.mark.parametrize("case", CASE_IDS + BLOCK_IDS)
def test_memory_record_has_the_references_keys(port, case):
    name, kind = case.split("-")
    coll, mem, _ = port[f"{name}_{kind}"]
    assert set(mem) == {"generated_code_size_in_bytes", "argument_size_in_bytes",
                        "output_size_in_bytes", "alias_size_in_bytes", "temp_size_in_bytes",
                        "peak_memory_in_bytes"}
    assert mem["generated_code_size_in_bytes"] is None and mem["alias_size_in_bytes"] == 0
    assert 0 < mem["temp_size_in_bytes"] < mem["peak_memory_in_bytes"]
    assert coll["moved_bytes"] > 0 and coll["all-reduce_count"] >= 2


def test_a_production_record_has_collectives_and_memory():
    rec = dryrun.run_one("qwen2-7b", "decode_32k")
    assert rec["mesh"] == "16x16"
    assert rec["collectives"]["moved_bytes"] > 0
    assert set(rec["collectives"]) >= {"all-gather", "all-gather_count", "all-reduce",
                                       "all-reduce_count", "moved_bytes"}
    mem = rec["memory_analysis"]
    # params, the cache, the (8, 1) tokens and the int32 idx
    assert mem["argument_size_in_bytes"] == (rec["param_bytes_per_device"]
                                             + rec["cache_bytes_per_device"] + 8 * 4 + 4)
    assert mem["peak_memory_in_bytes"] > mem["argument_size_in_bytes"]
    assert set(rec["notes"]) == {"memory_analysis"}
    json.dumps(rec)


@pytest.mark.parametrize("kind,nbytes,n", [("all-reduce", 1000, 4), ("all-gather", 1000, 16),
                                           ("reduce-scatter", 96, 2), ("all-to-all", 64, 8),
                                           ("collective-permute", 8, 2)])
def test_moved_bytes_is_the_references_ring_rule(kind, nbytes, n):
    assert moved_bytes(kind, nbytes, n) == _moved_bytes(kind, nbytes, n)


def test_the_counting_mesh_logs_and_refuses_real_tensors():
    from repro_torch.launch.mesh import collective_log
    mesh = CountingMesh(Mesh(("data", "model"), (2, 4)), {"data": 1, "model": 3})
    assert mesh.index("model") == 3 and mesh.index(("data", "model")) == 7
    x = torch.empty((2, 3), dtype=torch.bfloat16, device="meta")
    with collective_log() as log:
        g = mesh.all_gather(x, "model", dim=1)
        r = mesh.all_reduce(x, "data", op="max")
    assert g.shape == (2, 12) and g.dtype == torch.bfloat16 and r.shape == (2, 3)
    assert log == [("all-gather", 48, 4), ("all-reduce", 12, 2)]
    rec = collectives_record(log)
    assert rec == {"all-gather": 48.0, "all-gather_count": 1.0, "all-reduce": 12.0,
                   "all-reduce_count": 1.0, "moved_bytes": 48 * 3 / 4 + 2 * 12 / 2}
    with pytest.raises(ValueError, match="meta"):
        mesh.all_reduce(torch.zeros(3), "model")


@pytest.mark.parametrize("kind", KINDS)
def test_memory_counted_on_meta_equals_a_real_cpu_run(kind):
    """``count_memory`` of one step on meta against the same step on CPU
    tensors: the same storages are made and freed, so every figure
    agrees."""
    from repro_torch.launch import steps
    from repro_torch.launch.opcount import count_memory
    from repro_torch.models import cache as cache_lib, init_params
    from repro_torch.models.model import Model
    cfg = cfg_of("qwen2")
    b, s = 2, 24
    got = {}
    for dev in ("meta", "cpu"):
        model = (Model(cfg, device="meta") if dev == "meta" else
                 init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
        tokens = torch.zeros((b, s if kind == "prefill" else 1), dtype=torch.long, device=dev)
        with torch.no_grad():
            if kind == "prefill":
                got[dev] = count_memory(steps.make_prefill_step(cfg, s), model, tokens)[1]
            else:
                cache = cache_lib.make_cache(cfg, b, s, device=dev)
                got[dev] = count_memory(steps.make_serve_step(cfg), model, cache, tokens,
                                        s - 1)[1]
    assert got["meta"] == got["cpu"]
    assert got["cpu"]["temp_size_in_bytes"] > 0
