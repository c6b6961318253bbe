"""The train step under a process mesh: the dense and MoE stacks' forward,
backward, gradient sync, clip and optimizer as each rank of a mesh runs
them (``launch.steps.make_train_step`` inside ``meshctx.use_mesh``), over
four gloo ranks on the CPU.

The reference's ``make_train_step(cfg, warmup=0)`` of four reduced
float32 configs (2 layers; biases and G 2, qwen2-like; 3 query heads on 1
kv head, which a model axis of 2 does not divide; qwen3-moe with ``fsdp``
under AdamW and under Adafactor) is jitted with its rules' shardings
(``params_shardings``, ``opt_state_pspec``, ``batch_shardings``) as
``in_shardings`` and ``out_shardings``, as its dry-run's ``build_lowered``
makes them, on a (2, 2) ("data", "model") host mesh with
``AxisType.Auto`` axes, in a subprocess with four forced host devices,
and run for two steps on a (4, 16) batch. The port's ranks are spawned
once (``launch.mesh.spawn``); on a (2, 2) and a (2, 1, 2) ("pod", "data",
"model") mesh each loads the reference's draw cut to its blocks
(``weights.from_jax_params(..., mesh)``) and runs two steps on its rows,
logging its collectives. The same draw also runs in one process with no
mesh.

Held:

* ``loss``, ``ce``, ``aux`` and ``grad_norm`` of both steps within 1e-5
  relative of the reference's partitioned step and of one process;
* the optimizer state after step 1, which carries the first gradient
  (AdamW's ``m`` is 0.1 g, ``v`` 0.05 g^2; Adafactor's ``vr``, ``vc`` and
  ``v`` its row, column and full second moments): each rank's block
  within 1e-5 of the leaf's largest of the reference's leaf cut by the
  rules (``sharding.cut``), and of one process's;
* the parameters after step 2 within 0.1 x lr, absolute, of both.
  AdamW's first steps are about lr g / |g| elementwise, which turns
  summation-order differences of a gradient near zero into steps of up
  to lr (the reference's own partitioned step is 1.5e-5 from its
  single-device step at lr 3e-4 on the qwen2-like case);
* every rank's collective log of each step equal, call for call, to a
  ``CountingMesh``'s on ``meta`` at its coordinates;
* the MoE cases drop no assignment (capacity factor 2: an expert's
  capacity is every token of the call).

The collectives' transposes are tested on their own: a gathered tensor
has a ``grad_fn`` and its gradient is the reduce-scatter of the
cotangents, a sum all-reduce's gradient is the cotangents' sum,
``ProcessMesh.reduce_scatter`` equals an all-reduce then this rank's
slice, and ``op="max"`` refuses a tensor that requires grad. Rank 0's
train collectives are printed beside the compiled reference's, as moved
bytes (``PERF.md`` section 6), and not held: GSPMD picks its own.
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
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (CountingMesh, Mesh, ProcessMesh, collective_log,
                                     collectives_record, spawn)
from repro_torch.launch.steps import make_train_step
from repro_torch.models import meshctx
from repro_torch.models import moe as moe_lib
from repro_torch.models import sharding as shd
from repro_torch.models.model import Model
from repro_torch.weights import from_jax_params, reference_leaves

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x2": (("data", "model"), (2, 2)), "2x1x2": (("pod", "data", "model"), (2, 1, 2))}
MOE = dict(n_heads=4, n_kv_heads=2, d_head=64, fsdp=True)
# name: (arch, overrides, MoE capacity factor, optimizer)
CASES = {"qwen2": ("qwen2-7b", dict(n_heads=4, n_kv_heads=2, d_head=64), None, "adamw"),
         "odd": ("qwen2-7b", dict(d_model=192, n_heads=3, n_kv_heads=1, d_head=64, d_ff=384),
                 None, "adamw"),
         "moe": ("qwen3-moe-30b-a3b", MOE, 2.0, "adamw"),
         "moe-adafactor": ("qwen3-moe-30b-a3b", MOE, 2.0, "adafactor")}
BATCH, SEQ, STEPS, LR = 4, 16, 2, 3e-4
TOL = 1e-5            # metrics, relative; moments, of the leaf's largest
PARAM_TOL = 0.1 * LR  # parameters after step 2, absolute
METRICS = ("loss", "ce", "aux", "grad_norm")

_SCRIPT = r"""
import dataclasses, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config, reduced
from repro.launch import hloanalysis, steps
from repro.models import meshctx, model as jmodel, sharding as shd
from repro.optim.optimizers import opt_state_pspec

CASES = %(cases)r
LR = %(lr)r
batch = {k: jnp.asarray(np.asarray(v, np.int32)) for k, v in %(batch)r.items()}
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
meshctx.set_mesh(mesh)
paths = lambda tree: [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
                      for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
out = {}
for name, (arch, kw, cf, opt) in CASES.items():
    cfg = reduced(get_config(arch), n_layers=2).replace(optimizer=opt, **kw)
    if cf:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    train_step, opt_init = steps.make_train_step(cfg, base_lr=LR, warmup=0)
    state = opt_init(params)
    pspecs = shd.params_pspecs(mesh, params, cfg)
    # the shardings of the reference's dry-run (build_lowered), outputs too,
    # so one compiled step takes its own outputs
    shard = (shd.wrap(mesh, pspecs), shd.wrap(mesh, opt_state_pspec(cfg.optimizer, pspecs)),
             shd.batch_shardings(mesh, batch))
    mstruct = jax.eval_shape(train_step, params, state, batch)[2]
    msh = jax.tree_util.tree_map(lambda _: NamedSharding(mesh, P()), mstruct)
    args = jax.device_put((params, state, batch), shard)
    step = jax.jit(train_step, in_shardings=shard,
                   out_shardings=shard[:2] + (msh,)).lower(*args).compile()
    p1, s1, m1 = step(*args)
    p2, s2, m2 = step(p1, s1, args[2])
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
    if opt == "adafactor":     # slots in the params' flattened order, keyed by path
        s1 = dict(s1, slots=dict(zip(paths(params), s1["slots"])))
    out[name] = {"params": np_(params), "state1": np_(s1), "params2": np_(p2),
                 "metrics": [{k: float(v) for k, v in m.items()} for m in (m1, m2)],
                 "collectives": hloanalysis.analyze(step.as_text())["collectives"]}
pickle.dump(out, open(sys.argv[1], "wb"))
print("REF_OK")
"""


def cfg_of(name):
    arch, kw, cf, opt = CASES[name]
    cfg = reduced(get_config(arch), n_layers=2).replace(optimizer=opt, **kw)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf)) if cf else cfg


def the_batch():
    """(4, 16) tokens and their next-token labels, some ignored."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (BATCH, SEQ), dtype=np.int64)
    labels = np.roll(tokens, -1, 1)
    labels[:, -1] = -100
    labels[0, :3] = -100
    return {"tokens": tokens, "labels": labels}


def rows_of(mesh, n=BATCH):
    b = n // meshctx.dp_size(mesh)
    i = mesh.index(meshctx.dp_axes(mesh))
    return slice(i * b, (i + 1) * b)


def run_steps(model, cfg, batch):
    """``STEPS`` train steps: (each step's metrics, the state after step 1
    (cloned), the parameters after the last, each step's collective log,
    the dropped share of the MoE routings)."""
    train_step, opt_init = make_train_step(cfg, base_lr=LR, warmup=0)
    state = opt_init(model)
    metrics, logs, state1 = [], [], None
    with moe_lib.routing_log() as routes:
        for step in range(STEPS):
            with collective_log() as log:
                model, state, m = train_step(model, state, batch)
            metrics.append({k: float(v) for k, v in m.items()} if m["loss"].device.type != "meta"
                           else {})
            logs.append(list(log))
            if step == 0:
                state1 = _clone(state)
    dropped = routes.dropped_share() if m["loss"].device.type != "meta" else None
    return metrics, state1, [p.detach().clone() for p in model.parameters()], logs, dropped


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return [_clone(v) for v in tree]


def collectives_check(mesh):
    """The transposes on this rank: a gather and a sum over "model" of
    rank-dependent inputs, differentiated against rank-dependent weights;
    a reduce-scatter against an all-reduce and a slice; the max's
    refusal."""
    r = mesh.index(mesh.axis_names)
    g = torch.Generator().manual_seed(100 + r)
    x = torch.randn((2, 3), generator=g, requires_grad=True)
    c = torch.randn((2, 6), generator=g)
    y = mesh.all_gather(x, "model", dim=1)
    out = {"grad_fn": type(y.grad_fn).__name__ if y.grad_fn is not None else None,
           "requires_grad": y.requires_grad, "c": c}
    (y * c).sum().backward()
    out["gather_grad"] = x.grad.clone()
    x.grad = None
    z = mesh.all_reduce(x, "model")
    (z * c[:, :3]).sum().backward()
    out["reduce_grad"] = x.grad.clone()
    t = torch.randn((3, 4), generator=g)
    out["scatter"] = mesh.reduce_scatter(t, "model", dim=1)
    out["reduce_then_slice"] = mesh.all_reduce(t, "model")[:, shd.block_of(4, "model", mesh)]
    u = torch.randn((4, 2), generator=g, requires_grad=True)
    s = mesh.reduce_scatter(u, ("data", "model"))
    out["w"] = torch.randn(s.shape, generator=g)
    (s * out["w"]).sum().backward()
    out["scatter_grad"] = u.grad.clone()
    try:
        mesh.all_reduce(x, "model", op="max")
        out["max_refused"] = False
    except RuntimeError:
        out["max_refused"] = True
    with torch.no_grad():
        out["max_no_grad"] = mesh.all_reduce(x, "model", op="max")
    return out


def _rank(rank, device, ref, batch):
    meshes = {name: ProcessMesh(*spec) for name, spec in MESHES.items()}
    out = {"coords": {name: {a: m.index(a) for a in m.axis_names} for name, m in meshes.items()},
           "checks": {name: collectives_check(m) for name, m in meshes.items()}}
    for mname, mesh in meshes.items():
        rows = rows_of(mesh)
        local = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
        for name, r in ref.items():
            cfg = cfg_of(name)
            with meshctx.use_mesh(mesh):
                model = from_jax_params(r["params"], cfg, "cpu", mesh)
                out[(mname, name)] = run_steps(model, cfg, local)
    return out


@pytest.fixture(scope="module")
def batch():
    return the_batch()


@pytest.fixture(scope="module")
def ref(tmp_path_factory, batch):
    path = tmp_path_factory.mktemp("strain") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    script = _SCRIPT % {"cases": CASES, "lr": LR,
                        "batch": {k: v.tolist() for k, v in batch.items()}}
    res = subprocess.run([sys.executable, "-c", script, str(path)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert "REF_OK" in res.stdout, res.stdout + res.stderr
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks(ref, batch):
    light = {name: {"params": r["params"]} for name, r in ref.items()}
    return spawn(_rank, 4, "gloo", light, batch, device="cpu")


@pytest.fixture(scope="module")
def one(ref, batch):
    """Each case in one process, no mesh."""
    whole = {k: torch.from_numpy(v) for k, v in batch.items()}
    return {name: run_steps(from_jax_params(r["params"], cfg_of(name), "cpu"), cfg_of(name),
                            whole) for name, r in ref.items()}


def counting(mname, coords):
    return CountingMesh(Mesh(*MESHES[mname]), coords)


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def state_blocks(state, model_params, leaves, optimizer):
    """The port's optimizer state by the reference's path and slot name,
    each a tensor shaped as the rank's block of the reference's slot (a
    stacked leaf's per-layer slots stacked), with its spec (the leaf's
    live spec, the group axis first where the reference stacks)."""
    out = {}
    for k, leaf in enumerate(leaves):
        spec = tuple(getattr(model_params[leaf.index[0]], "spec", None)
                     or (None,) * model_params[leaf.index[0]].dim())
        spec = ((None,) if leaf.stacked else ()) + spec
        if optimizer == "adamw":
            slot = {n: torch.stack([state[n][i] for i in leaf.index]) if leaf.stacked
                    else state[n][leaf.index[0]] for n in ("m", "v")}
        else:
            slot = {n: torch.stack(t) if isinstance(t, list) else t
                    for n, t in state["slots"][k].items()}
        for n, t in slot.items():
            s = {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}.get(n, spec)
            out[(leaf.path, n)] = (t, s)
    return out


def ref_slot(ref_state, path, n, optimizer):
    return _at(ref_state, (n,) + path) if optimizer == "adamw" else ref_state["slots"][path][n]


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


CASE_IDS = [(m, n) for m in MESHES for n in CASES]
IDS = [f"{m}-{n}" for m, n in CASE_IDS]


@pytest.mark.parametrize("mname,name", CASE_IDS, ids=IDS)
def test_metrics_equal_the_references_partitioned_step(ref, ranks, mname, name):
    want = ref[name]["metrics"]
    for r in ranks:
        got = r[(mname, name)][0]
        for step in range(STEPS):
            for k in METRICS:
                assert rel(got[step][k], want[step][k]) <= TOL, (step, k)


@pytest.mark.parametrize("mname,name", CASE_IDS, ids=IDS)
def test_metrics_equal_one_process(ranks, one, mname, name):
    want = one[name][0]
    for r in ranks:
        got = r[(mname, name)][0]
        for step in range(STEPS):
            for k in METRICS + ("lr", "ppl_proxy"):
                assert rel(got[step][k], want[step][k]) <= TOL, (step, k)


@pytest.mark.parametrize("mname,name", CASE_IDS, ids=IDS)
def test_optimizer_state_after_step_one_holds_the_gradient(ref, ranks, one, mname, name):
    cfg = cfg_of(name)
    with meshctx.use_mesh(counting(mname, ranks[0]["coords"][mname])):
        meta = Model(cfg, device="meta")
    leaves = reference_leaves(meta)
    whole_params = list(from_jax_params(ref[name]["params"], cfg, "cpu").parameters())
    mine = state_blocks(one[name][1], whole_params, leaves, cfg.optimizer)
    for r in ranks:
        mesh = counting(mname, r["coords"][mname])
        with meshctx.use_mesh(mesh):
            specs = list(Model(cfg, device="meta").parameters())
        blocks = state_blocks(r[(mname, name)][1], specs, leaves, cfg.optimizer)
        assert blocks.keys() == mine.keys()
        for (path, n), (got, spec) in blocks.items():
            want = torch.from_numpy(np.asarray(ref_slot(ref[name]["state1"], path, n,
                                                        cfg.optimizer)))
            scale = float(want.abs().max())
            assert float((got - shd.cut(want, spec, mesh)).abs().max()) <= TOL * scale, (path, n)
            assert float((got - shd.cut(mine[(path, n)][0], spec, mesh)).abs().max()) \
                <= TOL * scale, (path, n)
        assert int(r[(mname, name)][1]["step"]) == 1


@pytest.mark.parametrize("mname,name", CASE_IDS, ids=IDS)
def test_parameters_after_step_two(ref, ranks, one, mname, name):
    cfg = cfg_of(name)
    one_params = one[name][2]
    for r in ranks:
        mesh = counting(mname, r["coords"][mname])
        with meshctx.use_mesh(mesh):
            specs = Model(cfg, device="meta")
        params = list(specs.parameters())
        got = r[(mname, name)][2]
        for leaf in reference_leaves(specs):
            a = np.asarray(_at(ref[name]["params2"], leaf.path))
            for gi, i in enumerate(leaf.index):
                want = torch.from_numpy(np.asarray(a[gi] if leaf.stacked else a))
                assert float((got[i] - shd.cut(want, params[i].spec, mesh)).abs().max()) \
                    <= PARAM_TOL, leaf.path
                assert float((got[i] - shd.cut(one_params[i], params[i].spec, mesh)).abs()
                             .max()) <= PARAM_TOL, leaf.path


@pytest.mark.parametrize("mname,name", CASE_IDS, ids=IDS)
def test_collective_log_equals_the_counting_mesh(ranks, batch, mname, name):
    cfg = cfg_of(name)
    for r in ranks:
        mesh = counting(mname, r["coords"][mname])
        rows = rows_of(mesh)
        meta = {k: torch.empty(v[rows].shape, dtype=torch.long, device="meta")
                for k, v in batch.items()}
        with meshctx.use_mesh(mesh):
            logs = run_steps(Model(cfg, device="meta"), cfg, meta)[3]
        got = r[(mname, name)][3]
        assert got == logs
        kinds = {k for k, _, _ in got[0]}
        assert {"all-gather", "all-reduce"} <= kinds
        if cfg.fsdp and mesh.shape["data"] > 1:
            assert "reduce-scatter" in kinds


@pytest.mark.parametrize("mname", MESHES)
@pytest.mark.parametrize("name", ["moe", "moe-adafactor"])
def test_the_moe_cases_drop_nothing(ranks, one, mname, name):
    assert one[name][4] == 0.0
    assert all(r[(mname, name)][4] == 0.0 for r in ranks)


@pytest.mark.parametrize("mname", MESHES)
def test_a_gather_differentiates_as_a_reduce_scatter(ranks, mname):
    for r in ranks:
        chk = r["checks"][mname]
        assert chk["grad_fn"] is not None and chk["requires_grad"]
        i = r["coords"][mname]["model"]
        group = [q for q in ranks if all(q["coords"][mname][a] == v
                                         for a, v in r["coords"][mname].items() if a != "model")]
        want = sum(q["checks"][mname]["c"][:, 3 * i:3 * i + 3] for q in group)
        assert torch.allclose(chk["gather_grad"], want, rtol=0, atol=1e-6)
        want = sum(q["checks"][mname]["c"][:, :3] for q in group)
        assert torch.allclose(chk["reduce_grad"], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mname", MESHES)
def test_reduce_scatter_equals_all_reduce_then_slice(ranks, mname):
    for r in ranks:
        chk = r["checks"][mname]
        assert torch.equal(chk["scatter"], chk["reduce_then_slice"])
        # its backward gathers the cotangents of the ranks along ("data",
        # "model"), in index order
        group = [q for q in ranks if q["coords"][mname].get("pod") == r["coords"][mname].get("pod")]
        group.sort(key=lambda q: (q["coords"][mname]["data"], q["coords"][mname]["model"]))
        assert torch.equal(chk["scatter_grad"], torch.cat([q["checks"][mname]["w"]
                                                           for q in group]))


@pytest.mark.parametrize("mname", MESHES)
def test_max_refuses_a_tensor_that_requires_grad(ranks, mname):
    for r in ranks:
        assert r["checks"][mname]["max_refused"]
        assert not r["checks"][mname]["max_no_grad"].requires_grad


def test_the_counting_mesh_differentiates_and_refuses_max():
    mesh = CountingMesh(Mesh(("data", "model"), (2, 4)), {"data": 1, "model": 2})
    x = torch.empty((3, 2), device="meta", requires_grad=True)
    with collective_log() as log:
        y = mesh.all_gather(x, "model", dim=1)
        assert y.grad_fn is not None and y.shape == (3, 8)
        z = mesh.reduce_scatter(mesh.all_reduce(y, "data"), ("data", "model"), dim=1)
        assert z.shape == (3, 1)
        z.sum().backward()
    assert x.grad.shape == (3, 2)
    assert [k for k, _, _ in log] == ["all-gather", "all-reduce", "reduce-scatter",
                                      "all-gather", "all-reduce", "reduce-scatter"]
    assert log[2] == ("reduce-scatter", 12, 8) and log[5] == ("reduce-scatter", 24, 4)
    with pytest.raises(RuntimeError, match="max"):
        mesh.all_reduce(x, "model", op="max")
    with torch.no_grad():
        assert mesh.all_reduce(x, "model", op="max").shape == (3, 2)


@pytest.mark.parametrize("name", CASES)
def test_rank0_train_collectives_beside_the_compiled_reference(ref, ranks, name):
    """Reported, not held (PERF.md section 6): rank 0's log of one step on
    the (2, 2) mesh as the reference's record, beside its compiled step's."""
    got = collectives_record(ranks[0][("2x2", name)][3][0])
    want = ref[name]["collectives"]
    kinds = sorted({k for k in list(got) + list(want)
                    if not k.endswith("_count") and k != "moved_bytes"})
    print(f"{name} train: moved_bytes port {got['moved_bytes']:.0f}, reference "
          f"{want['moved_bytes']:.0f} (ratio {got['moved_bytes'] / want['moved_bytes']:.3f}); "
          f"by kind (bytes, count) port "
          f"{ {k: (got.get(k, 0), got.get(k + '_count', 0)) for k in kinds} } reference "
          f"{ {k: (want.get(k, 0), want.get(k + '_count', 0)) for k in kinds} }")
    assert got["moved_bytes"] > 0 and want["moved_bytes"] > 0


def test_the_dry_run_counts_a_ranks_train_step():
    cfg = cfg_of("moe")
    coll, mem, seconds = dryrun.counted_rank(cfg, InputShape("train", SEQ, BATCH, "train"),
                                             Mesh(*MESHES["2x2"]))
    assert coll["reduce-scatter_count"] >= 1 and coll["all-reduce_count"] >= 2
    assert coll["moved_bytes"] > 0
    with meshctx.use_mesh(counting("2x2", {})):
        model = Model(cfg, device="meta")
        train_step, opt_init = make_train_step(cfg)
        state = opt_init(model)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    params = nbytes(list(model.parameters()))
    opt = nbytes(state["m"] + state["v"] + [state["step"]])
    batch = 2 * nbytes([torch.empty((BATCH // 2, SEQ), dtype=torch.int32)])
    assert mem["argument_size_in_bytes"] == params + opt + batch
    assert mem["peak_memory_in_bytes"] > mem["argument_size_in_bytes"]
    assert mem["temp_size_in_bytes"] > 0
