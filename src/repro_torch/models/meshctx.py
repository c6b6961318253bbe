"""Mesh context of the port (``src/repro/models/meshctx.py``): the mesh the
model code runs under, unset (None) for a single process.

Launch code sets a ``launch.mesh.ProcessMesh`` (``set_mesh`` or the
``use_mesh`` block) before it builds or runs a model; ``apply_moe`` then
takes the expert-parallel paths where ``ep_available`` holds, and the MoE
modules built under it hold a rank's shard of the expert leaves. The rules
read only the mesh's ``shape`` and ``axis_names``, so a ``launch.mesh.Mesh``
descriptor answers them too.

The reference's ``wsc_batch`` pins the residual stream's batch dim to the
data axes with a GSPMD layout constraint. It has no counterpart here: a
rank holds only its own shard of the batch, by construction.
"""
from __future__ import annotations

from contextlib import contextmanager

_MESH = None


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
