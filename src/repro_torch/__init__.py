"""PyTorch / CUDA port of the collaborative-inference system.

The JAX package ``repro`` is the reference; this package imports none of it
and no JAX. Its entry points run on the CUDA card unless the caller passes
``device="cpu"``; the hand-written kernels in ``repro_torch.kernels`` run on
CUDA tensors, their plain PyTorch twins on CPU tensors.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the CUDA card; raises when no card is
    present and none was asked for, rather than quietly using the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port's plain path on the CPU")
    return torch.device("cuda")


def full_precision_matmuls() -> None:
    """Keep f32 products in full f32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
