"""Transformer model of the port (dense blocks)."""
from repro_torch.models.model import Model, apply_model, init_params, layer_plan

__all__ = ["Model", "apply_model", "init_params", "layer_plan"]
