"""Mesh shapes of the port (``src/repro/launch/mesh.py``) and the card's
peak figures.

The reference builds ``jax.make_mesh`` over its devices. The port's dry-run
counts bytes and operations without running on the mesh, so a mesh here is
a plain descriptor: axis names mapped to sizes, frozen and hashable. The
sharding rules (``models/sharding.py``) read only its ``shape``,
``axis_names`` and ``size``, as the reference's read a ``jax.sharding.Mesh``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


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


# The card's peak figures, per GPU: NVIDIA H100 80GB HBM3 (SXM5) at 700 W,
# from NVIDIA's H100 spec sheet.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 on the tensor cores (spec sheet)
HBM_BW = 3.35e12              # B/s, HBM3 (spec sheet)
NVLINK_BW = 900e9             # B/s a GPU, over 18 NVLink links (spec sheet)
