"""Meshes of the port (``src/repro/launch/mesh.py``), the launcher of its
multi-process programs, and the card's peak figures.

The reference builds ``jax.make_mesh`` over its devices. The port has two
kinds of mesh. ``Mesh`` is a plain descriptor, axis names mapped to sizes,
frozen and hashable: the dry-run counts bytes and operations without
running, and its sharding rules (``models/sharding.py``) read only the
descriptor's ``shape``, ``axis_names`` and ``size``, as the reference's read
a ``jax.sharding.Mesh``. ``ProcessMesh`` lays the same axes over the ranks
of an initialised ``torch.distributed`` world (row-major, the last axis
fastest) and gives what the reference's per-shard code reads inside
``shard_map``: a rank's index on a set of axes (``jax.lax.axis_index``) and
the collectives over them (``all_gather(..., tiled=True)``, ``psum``,
``psum_scatter`` and ``pmax``).

The collectives carry gradients by JAX's transpose rules, each a
``torch.autograd.Function``: the backward of an all-gather is a
reduce-scatter of the cotangent (summed over the ranks, each keeping its
block), of a sum all-reduce an all-reduce of the cotangent, of a
reduce-scatter an all-gather. So a rank that differentiates its share of
a loss gets its share of the gradient of the whole program, with no case
at any call site. A ``max`` all-reduce has no transpose: it refuses an
input that requires grad in grad mode, as ``kernels._build.refuse_grad``
refuses for the forward-only kernels.

Every collective of a mesh is logged, forward and backward, as
``moe.routing_log`` logs routings: inside ``collective_log()`` each call
appends (kind, result bytes, group size) to the yielded list, the kind
under the reference's HLO name ("all-gather", "all-reduce",
"reduce-scatter"). ``CountingMesh`` has ``ProcessMesh``'s interface over a
``Mesh`` descriptor and one coordinate, with no process group: on ``meta``
tensors it returns results of the right shape and dtype and logs each call
as ``ProcessMesh`` does, its backward included, so the dry-run runs one
rank's program on ``meta`` and reads its collectives
(``collectives_record``, in the keys of the reference's
``collectives_weighted``).

``spawn(fn, world, backend)`` starts the ranks. Under ``nccl`` rank r runs
on card r, one rank a card; under ``gloo`` every rank runs on the one device
the caller names (ranks that share card 0, or the CPU), and gloo stages CUDA
tensors through the host. The backend is the caller's choice: nothing
switches it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import math
import os
import tempfile
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import full_precision_matmuls, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} sizes")
        if any(int(s) < 1 for s in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1, got {self.axis_sizes}")

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """Devices in the mesh."""
        return math.prod(self.axis_sizes)

    @property
    def label(self) -> str:
        """"16x16", "2x16x16": the dry-run records' name of the mesh."""
        return "x".join(str(s) for s in self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(model_axis: int = 1) -> Mesh:
    """A ("data", "model") mesh over the devices this process has: the
    cards ``torch.cuda.device_count()`` sees, or 1 on the CPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide {n} devices")
    return Mesh(("data", "model"), (n // model_axis, model_axis))


def _axes(names, axes):
    """``axes`` (a name or a tuple of names) as a tuple in mesh order."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    unknown = set(axes) - set(names)
    if unknown or not axes:
        raise ValueError(f"axes {axes} are not a non-empty subset of the mesh's {names}")
    return tuple(a for a in names if a in axes)


_LOGS = []


@contextlib.contextmanager
def collective_log():
    """Every collective a mesh runs inside the block, appended to the
    yielded list as (kind, result bytes, group size), in call order."""
    log = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def _logged(kind, result, group):
    for log in _LOGS:
        log.append((kind, result.numel() * result.element_size(), int(group)))
    return result


def moved_bytes(kind, result_bytes, n):
    """Bytes a device moves for one collective over a ring of ``n``, from
    its result bytes (the reference's ``hloanalysis._moved_bytes``)."""
    f = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * result_bytes * f
    if kind in ("all-gather", "all-to-all"):
        return result_bytes * f
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    return result_bytes          # collective-permute


def collectives_record(log):
    """A collective log as the reference's ``collectives_weighted`` record:
    ``<kind>`` (result bytes summed), ``<kind>_count`` and ``moved_bytes``.
    The port runs every layer in its Python loop, so its log is already
    weighted by the layers' trip counts."""
    out = {}
    for kind, nbytes, n in log:
        out[kind] = out.get(kind, 0.0) + float(nbytes)
        out[kind + "_count"] = out.get(kind + "_count", 0.0) + 1.0
        out["moved_bytes"] = out.get("moved_bytes", 0.0) + moved_bytes(kind, nbytes, n)
    return out


class _Axes:
    """What ``ProcessMesh`` and ``CountingMesh`` share: the descriptor's
    ``shape``, ``axis_names`` and ``size``, a rank's coordinates."""

    spec: Mesh
    _coords: dict

    @property
    def axis_names(self):
        return self.spec.axis_names

    @property
    def shape(self) -> dict:
        return self.spec.shape

    @property
    def size(self) -> int:
        return self.spec.size

    def axis_size(self, axes) -> int:
        """Ranks along ``axes`` (the product of their sizes)."""
        return math.prod(self.shape[a] for a in _axes(self.axis_names, axes))

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes``, the reference's
        ``axis_index`` (over a tuple: ``pod * n_data + data``)."""
        i = 0
        for a in _axes(self.axis_names, axes):
            i = i * self.shape[a] + self._coords[a]
        return i

    def all_gather(self, t, axes, dim=0):
        """The ``t`` of every rank along ``axes``, concatenated along
        ``dim`` in index order (``all_gather(..., tiled=True)``); its
        backward reduce-scatters the cotangent."""
        return _AllGather.apply(t, self, axes, dim % t.dim())

    def all_reduce(self, t, axes, op="sum"):
        """The sum (``psum``; its backward the sum of the cotangent) or,
        with ``op="max"``, the maximum (``pmax``, which refuses an input
        that requires grad in grad mode) of ``t`` over the ranks along
        ``axes``, in ``t``'s dtype, as a new tensor."""
        if op not in _REDUCE_OPS:
            raise ValueError(f"op must be one of {sorted(_REDUCE_OPS)}, got {op!r}")
        if op == "sum":
            return _AllReduce.apply(t, self, axes)
        if torch.is_grad_enabled() and t.requires_grad:
            raise RuntimeError("all_reduce(op='max') has no backward: run it on a detached "
                               "tensor or under torch.no_grad()")
        return self._reduce(t, axes, op)

    def reduce_scatter(self, t, axes, dim=0):
        """``t`` summed over the ranks along ``axes``, this rank keeping
        its block of ``dim`` (``psum_scatter(..., tiled=True)``); its
        backward all-gathers the cotangent."""
        return _ReduceScatter.apply(t, self, axes, dim % t.dim())


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh._gather(t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._scatter(g, ctx.axes, ctx.dim), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh._reduce(t, axes, "sum")

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._reduce(g, ctx.axes, "sum"), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh._scatter(t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._gather(g, ctx.axes, ctx.dim), None, None, None


def _block_len(t, dim, n):
    """The length of one rank's block of dim ``dim`` of ``t`` over ``n``."""
    if t.shape[dim] % n:
        raise ValueError(f"a reduce-scatter over {n} ranks cannot split dim {dim} of "
                         f"{tuple(t.shape)}")
    return t.shape[dim] // n


class ProcessMesh(_Axes):
    """The axes of a ``Mesh`` laid over the ranks of the initialised
    ``torch.distributed`` world: rank r sits at the row-major coordinates of
    r in ``axis_sizes``. Every rank must build it, in the same order as any
    other group: it makes one process group for every set of ranks that
    differ only on a subset of the axes. ``shape``, ``axis_names`` and
    ``size`` read as a ``Mesh``'s; ``index``, ``all_gather``,
    ``all_reduce`` and ``reduce_scatter`` take an axis name or a tuple of
    them. ``reduce_scatter`` is ``dist.reduce_scatter_single`` (formerly
    ``reduce_scatter_tensor``), which gloo takes on CPU and CUDA tensors
    alike."""

    def __init__(self, axis_names, axis_sizes):
        if not dist.is_available() or not dist.is_initialized():
            raise ValueError("a ProcessMesh needs an initialised torch.distributed world: start "
                             "the ranks with repro_torch.launch.mesh.spawn")
        self.spec = Mesh(tuple(axis_names), tuple(int(s) for s in axis_sizes))
        world = dist.get_world_size()
        if self.spec.size != world:
            raise ValueError(f"a {self.spec.label} mesh has {self.spec.size} ranks, the world "
                             f"{world}")
        self.rank = dist.get_rank()
        names, sizes = self.spec.axis_names, self.spec.axis_sizes
        grid = np.arange(world).reshape(sizes)
        self._coords = dict(zip(names, (int(c) for c in np.unravel_index(self.rank, sizes))))
        self._groups = {}
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n):
                keep = [names.index(a) for a in axes]
                rest = [i for i in range(len(names)) if i not in keep]
                rows = np.transpose(grid, rest + keep).reshape(-1, math.prod(
                    sizes[i] for i in keep))
                for ranks in rows:       # every rank makes every group, in one order
                    group = dist.new_group(sorted(int(r) for r in ranks))
                    if self.rank in ranks:
                        self._groups[axes] = group

    def group(self, axes):
        """The process group of this rank's neighbours along ``axes``."""
        return self._groups[_axes(self.axis_names, axes)]

    def _gather(self, t, axes, dim):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.axis_size(axes))]
        dist.all_gather(parts, t, group=self.group(axes))
        return _logged("all-gather", torch.cat(parts, dim=dim), len(parts))

    def _reduce(self, t, axes, op):
        out = t.contiguous().clone()
        dist.all_reduce(out, op=_REDUCE_OPS[op], group=self.group(axes))
        return _logged("all-reduce", out, self.axis_size(axes))

    def _scatter(self, t, axes, dim):
        n = self.axis_size(axes)
        b = _block_len(t, dim, n)
        x = t.movedim(dim, 0).contiguous()
        out = x.new_empty((b,) + x.shape[1:])
        _REDUCE_SCATTER(out, x, group=self.group(axes))
        return _logged("reduce-scatter", out.movedim(0, dim).contiguous(), n)


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# newer torch deprecates reduce_scatter_tensor for reduce_scatter_single; older has only the first
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


class CountingMesh(_Axes):
    """``ProcessMesh``'s interface for the rank at ``coords`` ({axis name:
    index}) of the ``Mesh`` descriptor ``spec``, with no process group: its
    collectives take ``meta`` tensors only (any other device raises, so no
    value is faked), return results of the right shape and dtype, made as
    ``ProcessMesh`` makes them (one part a rank, then one concatenation;
    a copy for a reduction; a block for a reduce-scatter), and are logged
    as ``ProcessMesh`` logs them, backward included."""

    def __init__(self, spec: Mesh, coords=None):
        self.spec = spec
        coords = dict(coords or {})
        if set(coords) - set(spec.axis_names):
            raise ValueError(f"coordinates {coords} name axes outside {spec.axis_names}")
        self._coords = {a: int(coords.get(a, 0)) for a in spec.axis_names}
        for a, i in self._coords.items():
            if not 0 <= i < spec.shape[a]:
                raise ValueError(f"coordinate {i} is off the {a} axis of {spec.label}")

    @staticmethod
    def _meta(t):
        if t.device.type != "meta":
            raise ValueError(f"a CountingMesh runs on meta tensors only, got one on {t.device}: "
                             f"run the ranks with a ProcessMesh")
        return t.contiguous()

    def _gather(self, t, axes, dim):
        t = self._meta(t)
        parts = [torch.empty_like(t) for _ in range(self.axis_size(axes))]
        return _logged("all-gather", torch.cat(parts, dim=dim), len(parts))

    def _reduce(self, t, axes, op):
        return _logged("all-reduce", self._meta(t).clone(), self.axis_size(axes))

    def _scatter(self, t, axes, dim):
        n = self.axis_size(axes)
        x = self._meta(t).movedim(dim, 0).contiguous()
        out = x.new_empty((_block_len(t, dim, n),) + x.shape[1:])
        return _logged("reduce-scatter", out.movedim(0, dim).contiguous(), n)


def rank_devices(world: int, backend: str, device=None):
    """Each rank's device: card r under ``nccl`` (one rank a card; raises
    when fewer cards are visible, naming ``gloo``), ``device`` (default the
    card) for every rank under ``gloo``."""
    if backend == "nccl":
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError(f"nccl runs on CUDA cards, not on {device}; use backend 'gloo'")
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < world:
            raise ValueError(f"nccl runs one rank a card: {world} ranks need {world} cards and "
                             f"{n} are visible; pass backend 'gloo' (--backend gloo) to run "
                             f"the ranks on one device")
        return [torch.device("cuda", r) for r in range(world)]
    if backend == "gloo":
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:     # a rank sets its card by index
            dev = torch.device("cuda", torch.cuda.current_device())
        return [dev] * world
    raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")


def _rank_main(rank, fn, world, backend, devices, tmp, threads, timeout_s, args):
    dev = devices[rank]
    torch.set_num_threads(threads)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    full_precision_matmuls()
    dist.init_process_group(backend, init_method="file://" + os.path.join(tmp, "store"),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, dev, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, backend: str, *args, device=None, timeout_s: float = 900.0):
    """Run ``fn(rank, device, *args)`` in ``world`` new processes, the ranks
    of a ``torch.distributed`` world on ``backend``, and return their
    results in rank order (loaded onto the CPU). ``fn`` must be importable
    by name (a module-level function) and its result saveable by
    ``torch.save``. The rendezvous is a ``FileStore`` in a fresh temporary
    directory, so concurrent launches never share a port. The devices are
    ``rank_devices``'s; each rank takes this process's CPU threads divided
    by ``world``. The kernels are built here, before the ranks start,
    so that they load one library. A rank that raises fails the launch
    with its traceback, and the other ranks are stopped. A collective
    that waits longer than ``timeout_s`` raises."""
    devices = rank_devices(world, backend, device)
    if devices[0].type == "cuda":
        from repro_torch.kernels import _build
        _build.build()
    with tempfile.TemporaryDirectory(prefix="repro_torch_spawn_") as tmp:
        # ranks that share the host split its threads (spinning OpenMP pools
        # that outnumber the cores slow every rank many times over)
        threads = max(1, torch.get_num_threads() // world)
        mp.start_processes(_rank_main, args=(fn, world, backend, devices, tmp, threads,
                                             timeout_s, args),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(world)]


# The card's peak figures, per GPU: NVIDIA H100 80GB HBM3 (SXM5) at 700 W,
# from NVIDIA's H100 spec sheet.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 on the tensor cores (spec sheet)
HBM_BW = 3.35e12              # B/s, HBM3 (spec sheet)
NVLINK_BW = 900e9             # B/s a GPU, over 18 NVLink links (spec sheet)
