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
  ``make_train_step`` (forward, backward and the optimizer) for train,
  ``make_prefill_step`` for prefill, ``make_serve_step`` for decode;
* ``count_s``, the seconds the count took (in the place of the
  reference's ``lower_s`` and ``compile_s``).

Two of the reference's fields are null, each with a line in ``notes``:
``collectives`` (it needs a sharded program of the dense layers) and ``memory_analysis``
(the port has no compiler's memory analysis, so no peak or temporary
memory). The counts do not depend on the mesh: each arch and shape is
counted once and the count serves both meshes. The process exits non-zero
if any combination failed.
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
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.opcount import count
from repro_torch.launch.steps import (attn_len_for, input_specs, make_prefill_step,
                                      make_serve_step, make_train_step, params_spec)
from repro_torch.models import sharding as shd
from repro_torch.models.layers import rope_inv_freqs
from repro_torch.optim.optimizers import opt_state_pspec, opt_state_structs

NOTES = {
    "collectives": "null: the collectives need a sharded program of the dense layers "
                   "(tensor parallelism over 'model'), which the port does not have",
    "memory_analysis": "null: the port has no compiler's memory analysis, so the peak "
                       "and temporary memory are not counted",
}


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
               bytes_accessed=costs["bytes_accessed"], count_s=round(seconds, 2),
               collectives=None, memory_analysis=None, notes=dict(NOTES))
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
