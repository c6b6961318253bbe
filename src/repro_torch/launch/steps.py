"""Step builders of the port (``src/repro/launch/steps.py``): the prefill
and serve closures over a ModelConfig. The training step and the dry-run
input specs come with the training slice."""
from __future__ import annotations

from repro_torch.models import model as model_lib


def _check(model, cfg):
    if model.cfg != cfg:
        raise ValueError(f"the model was built for {model.cfg.name}, the step for {cfg.name}")


def make_prefill_step(cfg, attn_len: int):
    """``prefill_step(model, tokens) -> (last_logits, cache)``, the cache of
    ``attn_len`` slots per attention layer."""
    def prefill_step(model, tokens):
        _check(model, cfg)
        return model_lib.prefill(model, tokens, attn_len=attn_len)
    return prefill_step


def make_serve_step(cfg):
    """``serve_step(model, cache, token, idx) -> (logits, cache)``: one
    greedy-decode step of token (B, 1) at position idx."""
    def serve_step(model, cache, token, idx):
        _check(model, cfg)
        return model_lib.decode_step(model, cache, token, idx)
    return serve_step
