"""A model trained under a process mesh saved as the reference's whole
params tree (``weights.to_reference_tree`` under ``meshctx.use_mesh``,
then ``ckpt.save_checkpoint`` on rank 0), and loaded back into one
process and into the mesh.

Four gloo ranks on the CPU form a (2, 2) ("data", "model") mesh. Each
draws a reduced float32 model as one process draws it (``init_params``
under the mesh keeps the rank's blocks of the one-process draw) and runs
one train step of ``make_train_step`` (remat on, as the configs have it)
on its rows of a (4, 16) batch, for a qwen2-like dense case and the
qwen3-moe case with ``fsdp`` (expert leaves cut over "model" and, with
fsdp, over "data"). Then every rank takes the tree, gathering each
parameter's blocks over the axes that cut it, and rank 0 writes it.

Held:

* rank 0's file is the reference's tree: the JAX package's own
  ``load_checkpoint`` restores it into the structure of the reference's
  ``init_params``, with its leaves' shapes and dtypes;
* it equals one process's ``to_reference_tree`` after the same step on
  the whole batch, leaf for leaf: the same paths, shapes and dtypes, and
  values within 0.1 lr (``tests/test_torch_sharded_train.py``'s bound on
  the parameters after a step: AdamW's first step is about lr g / |g|, so
  a summation-order difference of a gradient near zero moves an element
  by up to lr);
* every rank's tree is that file's, bit for bit;
* the file loads into one process (``from_jax_params``) with every
  parameter equal to its leaf, and into the mesh with every rank's blocks
  equal to those it trained;
* a rank's collective log of the train step, the recompute's collectives
  included, equals a ``CountingMesh``'s on ``meta`` call for call, and is
  longer than the same step's without remat.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import CountingMesh, Mesh, ProcessMesh, collective_log, spawn
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params, meshctx
from repro_torch.models.model import Model
from repro_torch.weights import from_jax_params, to_reference_tree

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

MESH = (("data", "model"), (2, 2))
# name: (arch, overrides, MoE capacity factor)
CASES = {"qwen2": ("qwen2-7b", dict(n_heads=4, n_kv_heads=2, d_head=64), None),
         "moe": ("qwen3-moe-30b-a3b", dict(n_heads=4, n_kv_heads=2, d_head=64, fsdp=True), 2.0)}
BATCH, SEQ, LR = 4, 16, 3e-4
PARAM_TOL = 0.1 * LR


def cfg_of(name):
    arch, kw, cf = CASES[name]
    cfg = reduced(get_config(arch), n_layers=2).replace(**kw)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf)) if cf else cfg


def the_batch():
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 512, (BATCH, SEQ), dtype=np.int64))
    labels = tokens.roll(-1, 1)
    labels[:, -1] = -100
    return {"tokens": tokens, "labels": labels}


def rows_of(mesh):
    b = BATCH // meshctx.dp_size(mesh)
    i = mesh.index(meshctx.dp_axes(mesh))
    return slice(i * b, (i + 1) * b)


def one_step(model, cfg, batch):
    """One train step; returns its collective log."""
    train_step, opt_init = make_train_step(cfg, base_lr=LR, warmup=0)
    with collective_log() as log:
        train_step(model, opt_init(model), batch)
    return list(log)


def _rank(rank, device, folder):
    mesh = ProcessMesh(*MESH)
    out = {"coords": {a: mesh.index(a) for a in mesh.axis_names}}
    batch = {k: v[rows_of(mesh)] for k, v in the_batch().items()}
    for name in CASES:
        cfg = cfg_of(name)
        path = f"{folder}/{name}"
        with meshctx.use_mesh(mesh):
            model = init_params(cfg, torch.Generator().manual_seed(0), device)
            log = one_step(model, cfg, batch)
            tree = to_reference_tree(model)
            if rank == 0:
                save_checkpoint(path, tree, step=1)
            dist.barrier()
            loaded, _ = load_checkpoint(path, tree)
            back = from_jax_params(loaded, cfg, device, mesh)
        blocks_equal = all(torch.equal(a, b) for a, b in zip(back.parameters(),
                                                            model.parameters()))
        out[name] = {"log": log, "tree": tree, "blocks_equal": blocks_equal}
    return out


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return tmp_path_factory.mktemp("sharded_ckpt")


@pytest.fixture(scope="module")
def ranks(folder):
    return spawn(_rank, 4, "gloo", str(folder), device="cpu")


@pytest.fixture(scope="module")
def one():
    """Each case's model after one step on the whole batch, one process."""
    out = {}
    for name in CASES:
        cfg = cfg_of(name)
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        one_step(model, cfg, the_batch())
        out[name] = model
    return out


def _leaves(tree, prefix=()):
    """{path: leaf} of a nested tree of dicts and lists."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _leaves(tree[k], prefix + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree) for p, v in _leaves(x, prefix + (i,)).items()}
    return {prefix: tree}


def _saved(folder, name, like):
    return load_checkpoint(str(folder / name), like)


@pytest.mark.parametrize("name", CASES)
def test_the_file_is_the_references_tree(ranks, folder, name):
    # the JAX package only here: the spawned ranks import this module
    import jax
    from repro.ckpt.checkpoint import load_checkpoint as jload_checkpoint
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models.model import init_params as jinit_params

    arch, kw, cf = CASES[name]
    jcfg = jreduced(jget_config(arch), n_layers=2).replace(**kw)
    if cf:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    like = jax.eval_shape(lambda: jinit_params(jcfg, jax.random.PRNGKey(0)))
    tree, meta = jload_checkpoint(str(folder / name), like)
    assert meta["step"] == 1
    got = jax.tree_util.tree_leaves_with_path(tree)
    want = jax.tree_util.tree_leaves_with_path(like)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), path


@pytest.mark.parametrize("name", CASES)
def test_the_file_equals_one_process_tree(ranks, one, folder, name):
    want = to_reference_tree(one[name])
    got, _ = _saved(folder, name, want)
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert (g.shape, g.dtype) == (w.shape, w.dtype), path
        assert float((g - w).abs().max()) <= PARAM_TOL, path


@pytest.mark.parametrize("name", CASES)
def test_every_rank_takes_the_same_whole_tree(ranks, folder, name):
    saved, _ = _saved(folder, name, ranks[0][name]["tree"])
    saved = _leaves(saved)
    for r in ranks:
        tree = _leaves(r[name]["tree"])
        assert tree.keys() == saved.keys()
        assert all(torch.equal(tree[p], saved[p]) for p in saved)


@pytest.mark.parametrize("name", CASES)
def test_the_file_loads_into_one_process_and_into_the_mesh(ranks, one, folder, name):
    cfg = cfg_of(name)
    tree, _ = _saved(folder, name, to_reference_tree(one[name]))
    got, want = _leaves(to_reference_tree(from_jax_params(tree, cfg, "cpu"))), _leaves(tree)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[p], want[p]) for p in want)
    assert all(r[name]["blocks_equal"] for r in ranks)


@pytest.mark.parametrize("name", CASES)
def test_the_train_steps_collectives_include_the_recompute(ranks, name):
    cfg = cfg_of(name)
    for r in ranks:
        mesh = CountingMesh(Mesh(*MESH), r["coords"])
        rows = rows_of(mesh)
        meta = {k: torch.empty(v[rows].shape, dtype=v.dtype, device="meta")
                for k, v in the_batch().items()}
        logs = {}
        for remat in (True, False):
            c = cfg.replace(remat=remat)
            with meshctx.use_mesh(mesh):
                logs[remat] = one_step(Model(c, device="meta"), c, meta)
        assert r[name]["log"] == logs[True]
        assert len(logs[True]) > len(logs[False])
