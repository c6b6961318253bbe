"""Weight quantization of the distilled dispatch trunk, the port of
``src/repro/rl/distill.py::quantize_flat_trunk``. The distillation
training (``distill_entity_policy``, ``action_agreement``) comes with the
training slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops


@torch.no_grad()
def quantize_flat_trunk(p, bits=8):
    """Per-layer min-max weight quantization of the float32 trunk (paper
    Eq. 1 on the weights, one (mn, mx) pair per layer, through the same
    ``ops.quantize`` codes as the feature compressor). Biases stay float32;
    mn and mx are float32 host scalars. The result feeds
    ``nets.flat_trunk_forward``."""
    qlayers = []
    for layer in p.layers:
        w = layer.w.detach().contiguous()
        mn, mx = (np.float32(v.item()) for v in torch.aminmax(w))
        qlayers.append({"codes": ops.quantize(w, mn, mx, bits=bits), "mn": mn, "mx": mx,
                        "b": layer.b.detach().to(torch.float32)})
    return {"qlayers": qlayers, "bits": int(bits)}
