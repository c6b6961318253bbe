"""Carry weights from the JAX reference into the port.

``from_jax_params`` takes the output of the reference's
``models.init_params`` as a tree of numpy arrays (the caller does the
``np.asarray`` on the JAX side; this module imports no JAX) and returns the
port's ``Model``. The reference stacks each block parameter on a leading
layer axis (``params["decoder"]["blocks"][0][...]`` has shape
``(n_layers, ...)``); the port keeps one module per layer, in the same
(d_in, d_out) layouts, so the stacks are only unstacked.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.blocks import _LATER
from repro_torch.models.model import Model, layer_plan


def _tensor(a, dtype, device):
    # float32 first: numpy cannot hand bfloat16 arrays to torch directly,
    # and widening bf16 to f32 is exact.
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(
        device=device, dtype=dtype)


_SUBMODULES = {  # uniform pattern: the stacked subtrees of its block
    ("dense",): ("ln1", "ln2", "attn", "mlp"),
    ("mamba2",): ("ln1", "mixer"),
}


@torch.no_grad()
def from_jax_params(tree, cfg, device):
    """The port's Model holding the reference parameters ``tree``. Each
    parameter keeps its own dtype (the Mamba ``A_log``, ``D`` and
    ``dt_bias`` stay float32 in a bfloat16 model)."""
    pattern, _, tail = layer_plan(cfg)
    if pattern not in _SUBMODULES or tail:
        later = sorted({_LATER[bt] for bt in pattern + tail if bt in _LATER})
        raise NotImplementedError(
            f"block pattern {pattern} (tail {tail}) is not carried yet; it comes "
            f"with {', '.join(later) or 'the model-zoo slice'}")
    model = Model(cfg, device=device)
    load = lambda param, a: param.copy_(_tensor(a, param.dtype, device))
    load(model.embed, tree["embed"])
    if model.lm_head is not None:
        load(model.lm_head, tree["lm_head"])
    dec = tree["decoder"]
    stacked = dec["blocks"][0]
    for i, blk in enumerate(model.blocks):
        for sub in _SUBMODULES[pattern]:
            mod = getattr(blk, sub)
            for name, arr in stacked[sub].items():
                load(getattr(mod, name), arr[i])
    for name, arr in dec["ln_f"].items():
        load(getattr(model.ln_f, name), arr)
    return model


def ae_from_numpy(ae, device):
    """{"enc": (d, d'), "dec": (d', d)} numpy arrays -> float32 tensors."""
    return {k: _tensor(ae[k], torch.float32, device) for k in ("enc", "dec")}
