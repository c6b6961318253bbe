"""The dry-run without running: for every (arch x input shape) combination,
what one device of a production mesh would hold, and what the step costs,
counted on ``meta`` (``src/repro/launch/dryrun.py``, which lowers and
compiles each step for 256 or 512 forced host devices).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--out DIR]

Each combination writes one JSON record to ``--out`` (default
``artifacts/dryrun_torch``):

* ``arch``, ``shape``, ``mesh`` ("16x16" or "2x16x16"), ``n_devices``;
* ``param_bytes_per_device``, and ``opt_bytes_per_device`` for train or
  ``cache_bytes_per_device`` for prefill and decode: the reference's
  sharding rules applied to its leaves as byte arithmetic
  (``models/sharding.py``, ``optim.opt_state_pspec``);
* ``flops``, ``dot_flops`` and ``bytes_accessed`` of the whole step,
  unpartitioned, counted on ``meta`` (``launch/opcount.py``): the port's
  ``make_train_step`` (forward, backward with the recomputed forward of
  each layer group, and the optimizer) for train,
  ``make_prefill_step`` for prefill, ``make_serve_step`` for decode;
* ``count_s``, the seconds the counts took (in the place of the
  reference's ``lower_s`` and ``compile_s``).

For every step of every arch (each block type has its tensor-parallel
program), two more fields come from the program rank 0 of the mesh runs,
counted on ``meta`` under a ``launch.mesh.CountingMesh`` at the
production mesh's shape, on its shard
of the inputs (``input_specs(..., mesh)``; a batch the data axes do not
divide, long_500k's, whole on every rank); for train, ``make_train_step``
on the rank's blocks of the parameters and of the optimizer state:

* ``collectives``: the mesh's log of that run as the reference's
  ``collectives_weighted``, ``<kind>``, ``<kind>_count`` and
  ``moved_bytes`` (``launch.mesh.collectives_record``); the port's Python
  loop runs every layer, so the counts are already weighted; a train
  step's are its forward's, its recompute's, its backward's (the
  collectives' transposes), the gradient sync's and the global norm's;
* ``memory_analysis``: the reference's keys (``opcount.count_memory``):
  ``argument_size_in_bytes`` (the rank's parameters, and its optimizer
  state and batch or its cache and inputs, those the step reads, as XLA
  drops the arguments a compiled step never reads: at decode an
  encoder's parameters and a cross-attention layer's context projections;
  at decode of an arch with self-attention the 4 bytes of the reference's
  int32 ``idx``, which the port takes as a Python int),
  ``output_size_in_bytes`` (its logits and cache, or its parameters,
  optimizer state and metrics, with the 8 bytes a leaf of the table of the
  reference's output tuple, over the reference's stacked leaves),
  ``alias_size_in_bytes`` 0 (the reference donates nothing),
  ``temp_size_in_bytes`` and ``peak_memory_in_bytes`` (the most bytes of
  live storages the run reaches, autograd's saved tensors among them,
  without and with the arguments') and ``generated_code_size_in_bytes``
  null, with a note. A train step recomputes each layer group as the
  reference's does (``cfg.remat``, ``models/model.py``), so between the
  forward and the backward only the groups' inputs are kept, and the
  counts and the collectives include the recomputed forwards.

These counts depend on the mesh, so ``counted_rank`` keeps them by arch,
shape and mesh. mamba2-1.3b's residual stream is sequence-parallel in
train and prefill (``seq_parallel_residual``, ``meshctx.seq_parallel``):
the rank's program all-gathers each layer's normed input along the
sequence and reduce-scatters its ``out_proj`` (the same bytes by the ring
rule as the all-reduce it replaces), gathers the residual whole once at
the stack's end, and in a train step gathers each layer's input again in
the recompute; its remat groups keep 1 / model of the residual. The
reference's compiled program keeps its all-reduces under the same flag
and adds all-gathers, all-to-alls and collective-permutes around them.
The process exits non-zero if any combination failed.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch.mesh import (CountingMesh, collective_log, collectives_record,
                                     make_production_mesh)
from repro_torch.launch.opcount import count, count_memory
from repro_torch.launch.steps import (attn_len_for, input_specs, make_prefill_step,
                                      make_serve_step, make_train_step, params_spec)
from repro_torch.models import meshctx
from repro_torch.models import sharding as shd
from repro_torch.models.layers import rope_inv_freqs
from repro_torch.optim.optimizers import opt_state_pspec, opt_state_structs

CODE_NOTE = ("generated_code_size_in_bytes is null: the port generates no code for a step "
             "(its kernels are built once, not per step)")
IDX_BYTES = 4       # the reference's decode takes idx as an int32 scalar argument (where read)
TUPLE_BYTES = 8     # a pointer a leaf in the table of the reference's output tuple


@functools.lru_cache(maxsize=None)
def counted(cfg, shape):
    """``(costs, seconds, cache)`` of the step the input shape ``shape``
    runs for ``cfg``, counted once on ``meta``; ``cache`` is the prefill's
    output cache or the decode's input cache (the port's per-layer list),
    None for train."""
    specs = input_specs(cfg, shape)
    model = params_spec(cfg)
    # RoPE's inverse frequencies are built once a device and cached: each
    # count builds them itself, so a record does not depend on what was
    # counted before it in the process
    rope_inv_freqs.cache_clear()
    t0 = time.perf_counter()
    if shape.kind == "train":
        train_step, opt_init = make_train_step(cfg)
        costs, _ = count(train_step, model, opt_init(model), specs["batch"])
        cache = None
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, attn_len_for(cfg, shape))
        with torch.no_grad():
            costs, (_, cache) = count(step, model, specs["tokens"], specs.get("aux_embeds"))
    else:
        # the port's decode takes the position as an int: the shape's last
        # (no product's shape depends on it)
        cache = specs["cache"]
        with torch.no_grad():
            costs, _ = count(make_serve_step(cfg), model, cache, specs["token"],
                             shape.seq_len - 1)
    return costs, time.perf_counter() - t0, cache


@functools.lru_cache(maxsize=None)
def counted_rank(cfg, shape, mesh):
    """``(collectives, memory_analysis, seconds)`` of the train step,
    prefill or decode that rank 0 of ``mesh`` (a ``Mesh`` descriptor) runs,
    counted on ``meta`` under a ``CountingMesh`` (see the module's
    docstring)."""
    cmesh = CountingMesh(mesh)
    rope_inv_freqs.cache_clear()
    t0 = time.perf_counter()
    whole = shape.global_batch % meshctx.dp_size(mesh) != 0
    train = shape.kind == "train"
    with meshctx.use_mesh(cmesh), meshctx.whole_batch(whole), torch.set_grad_enabled(train):
        specs = input_specs(cfg, shape, mesh=cmesh)
        model = params_spec(cfg)
        with collective_log() as log:
            if train:
                train_step, opt_init = make_train_step(cfg)
                state = opt_init(model)
                _, memory, (_, _, metrics) = count_memory(train_step, model, state,
                                                          specs["batch"])
            elif shape.kind == "prefill":
                step = make_prefill_step(cfg, attn_len_for(cfg, shape))
                _, memory, (_, cache) = count_memory(step, model, specs["tokens"],
                                                     specs.get("aux_embeds"))
            else:
                _, memory, (_, cache) = count_memory(make_serve_step(cfg), model,
                                                     specs["cache"], specs["token"],
                                                     shape.seq_len - 1)
                if any("pos" in entry for entry in cache):    # a self-attention reads idx
                    memory["argument_size_in_bytes"] += IDX_BYTES
    if train:   # the reference returns its params, its optimizer state and the metrics
        params = shd.reference_params(model)
        leaves = len(params) + len(opt_state_structs(cfg.optimizer, params)) + len(metrics)
    else:
        leaves = 1 + len(shd.reference_cache(cfg, cache))
    memory["output_size_in_bytes"] += TUPLE_BYTES * leaves
    return collectives_record(log), memory, time.perf_counter() - t0


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False):
    """The record of one combination (see the module's docstring)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    costs, seconds, cache = counted(cfg, shape)
    params = shd.reference_params(params_spec(cfg))
    pspecs = shd.params_pspecs(mesh, params, cfg)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh.label, "n_devices": mesh.size,
           "param_bytes_per_device": shd.bytes_per_device(params, pspecs, mesh)}
    if cache is None:
        rec["opt_bytes_per_device"] = shd.bytes_per_device(
            opt_state_structs(cfg.optimizer, params), opt_state_pspec(cfg.optimizer, pspecs),
            mesh)
    else:
        tree = shd.reference_cache(cfg, cache)
        rec["cache_bytes_per_device"] = shd.bytes_per_device(
            tree, shd.cache_pspecs(mesh, tree, cfg), mesh)
    rec.update(flops=costs["flops"], dot_flops=costs["dot_flops"],
               bytes_accessed=costs["bytes_accessed"])
    rec["collectives"], rec["memory_analysis"], rank_s = counted_rank(cfg, shape, mesh)
    rec["notes"] = {"memory_analysis": CODE_NOTE}
    seconds += rank_s
    rec["count_s"] = round(seconds, 2)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list(ARCH_IDS) if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {tag}")
                    continue
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    rec = run_one(arch, shape, multi_pod=mp)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    held = rec.get("opt_bytes_per_device", rec.get("cache_bytes_per_device"))
                    print(f"[ok] {tag} count={rec['count_s']}s flops={rec['flops']:.3e} "
                          f"params={rec['param_bytes_per_device']:.3e}B "
                          f"{'opt' if 'opt_bytes_per_device' in rec else 'cache'}={held:.3e}B",
                          flush=True)
                except Exception:
                    failures += 1
                    with open(path + ".err", "w") as f:
                        f.write(traceback.format_exc())
                    print(f"[FAIL] {tag}")
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} dry-run combinations failed")
    print("all dry-run combinations counted OK")


if __name__ == "__main__":
    main()
