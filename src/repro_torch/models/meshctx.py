"""Mesh context of the port (``src/repro/models/meshctx.py``): the mesh the
model code runs under, unset (None) for a single process.

Launch code sets a ``launch.mesh.ProcessMesh`` (``set_mesh`` or the
``use_mesh`` block) before it builds or runs a model, or a
``CountingMesh`` to count one rank's program on meta: a model built under
it holds the rank's blocks of its leaves (``sharding.localize``), every
block type runs its tensor-parallel program (``models/tp.py``,
``attention``'s self- and cross-attention, ``ssm`` and ``rglru``'s
mixers), and ``apply_moe`` takes the
expert-parallel paths where ``ep_available`` holds. The rules
read only the mesh's ``shape`` and ``axis_names``, so a ``launch.mesh.Mesh``
descriptor answers them too.

The reference's ``wsc_batch`` pins the residual stream's batch dim to the
data axes with a GSPMD layout constraint. Its batch half has no
counterpart here: a rank holds only its own shard of the batch, by
construction. A batch the data axes do not divide stays whole on every
data rank (the reference's ``batch_shardings``); a rank cannot tell that
from its tokens' shape, so the caller runs such a batch inside
``whole_batch()``. Its sequence half, ``seq_parallel_residual``, is
``seq_parallel``: where it holds, the model cuts the residual stream along
the sequence over "model" between layers (``models/model.py``), and each
residual branch of every block type all-gathers its normed input and
reduce-scatters its row-parallel output along the sequence
(``models/blocks.py``; Megatron-style sequence parallelism); nothing else
changes. Elsewhere every rank of "model" holds the whole residual.
"""
from __future__ import annotations

from contextlib import contextmanager

_MESH = None
_WHOLE_BATCH = False


def set_mesh(mesh):
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


@contextmanager
def use_mesh(mesh):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev


def dp_axes(mesh=None):
    """The data-parallel axes of ``mesh`` (default: the current one):
    ("pod", "data") where it has a pod axis, else ("data",); None without
    a mesh."""
    m = _MESH if mesh is None else mesh
    if m is None:
        return None
    return ("pod", "data") if "pod" in m.axis_names else ("data",)


def dp_size(mesh=None) -> int:
    """Ranks along the data-parallel axes (1 without a mesh)."""
    m = _MESH if mesh is None else mesh
    n = 1
    for a in dp_axes(m) or ():
        n *= m.shape[a]
    return n


def ep_available(cfg, mesh=None):
    """Whether the expert-parallel paths can run ``cfg`` on ``mesh``
    (default: the current one): an MoE config, a "model" axis that divides
    the experts, and with ``fsdp`` a "data" axis that divides d_model."""
    m = _MESH if mesh is None else mesh
    if m is None or cfg.moe is None or "model" not in m.axis_names:
        return False
    if cfg.moe.n_experts % m.shape["model"] != 0:
        return False
    if cfg.fsdp and cfg.d_model % m.shape["data"] != 0:
        return False
    return True


@contextmanager
def whole_batch(whole=True):
    """Inside the block every rank holds the whole batch (a batch the data
    axes do not divide), not its data index's rows."""
    global _WHOLE_BATCH
    prev = _WHOLE_BATCH
    _WHOLE_BATCH = whole
    try:
        yield
    finally:
        _WHOLE_BATCH = prev


def batch_is_whole() -> bool:
    return _WHOLE_BATCH


def seq_parallel(cfg, x, mode) -> bool:
    """Whether the residual stream ``x`` runs cut along the sequence over
    "model" (the reference's ``wsc_batch(x, seq_parallel=...)``): the flag
    ``cfg.seq_parallel_residual`` set, ``mode`` train or prefill, a mesh
    whose "model" axis has more than one rank and divides x's sequence
    (x (B, S, d) with S > 1), and x this rank's shard of the batch (not
    under ``whole_batch()``, where the reference's constraint is not
    applied either). Decode, one process and a whole batch never are.
    Every block type has the sequence-parallel program
    (``models/blocks.py``)."""
    m = _MESH
    if not cfg.seq_parallel_residual or mode not in ("train", "prefill") or m is None:
        return False
    if "model" not in m.axis_names or m.shape["model"] <= 1 or _WHOLE_BATCH:
        return False
    return x.dim() == 3 and x.shape[1] > 1 and x.shape[1] % m.shape["model"] == 0


def global_batch(local: int, mesh=None) -> int:
    """The global batch of which a rank holds ``local`` rows."""
    return local if _WHOLE_BATCH else local * dp_size(mesh)
