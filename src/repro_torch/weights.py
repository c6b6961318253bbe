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

from repro_torch.models.layers import dtype_of
from repro_torch.models.model import Model, layer_plan


def _tensor(a, dtype, device):
    # float32 first: numpy cannot hand bfloat16 arrays to torch directly,
    # and widening bf16 to f32 is exact.
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(
        device=device, dtype=dtype)


@torch.no_grad()
def from_jax_params(tree, cfg, device):
    """The port's Model holding the reference parameters ``tree``."""
    pattern, _, tail = layer_plan(cfg)
    if pattern != ("dense",) or tail:
        raise NotImplementedError("only uniform dense stacks are ported")
    model = Model(cfg, device=device)
    dt = dtype_of(cfg.param_dtype)
    t = lambda a: _tensor(a, dt, device)
    model.embed.copy_(t(tree["embed"]))
    if model.lm_head is not None:
        model.lm_head.copy_(t(tree["lm_head"]))
    dec = tree["decoder"]
    stacked = dec["blocks"][0]
    for i, blk in enumerate(model.blocks):
        for sub, mod in (("ln1", blk.ln1), ("ln2", blk.ln2),
                         ("attn", blk.attn), ("mlp", blk.mlp)):
            for name, arr in stacked[sub].items():
                getattr(mod, name).copy_(t(arr[i]))
    for name, arr in dec["ln_f"].items():
        getattr(model.ln_f, name).copy_(t(arr))
    return model


def ae_from_numpy(ae, device):
    """{"enc": (d, d'), "dec": (d', d)} numpy arrays -> float32 tensors."""
    return {k: _tensor(ae[k], torch.float32, device) for k in ("enc", "dec")}
