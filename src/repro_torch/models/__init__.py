"""Models of the port: dense transformer, mixture-of-experts, hybrid (RG-LRU
+ local attention) and Mamba-2 stacks."""
from repro_torch.models.model import (Model, apply_model, decode_step, init_params, layer_plan,
                                      loss_fn, prefill)

__all__ = ["Model", "apply_model", "decode_step", "init_params", "layer_plan", "loss_fn",
           "prefill"]
