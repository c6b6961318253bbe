"""Step builders of the port (``src/repro/launch/steps.py``): the training,
prefill and serve closures over a ModelConfig, and the dry-run's input
specs: ``meta`` tensors standing in for every input of the step an input
shape runs, as the reference's ``ShapeDtypeStruct`` leaves do (nothing is
allocated or executed on ``meta``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.models import cache as cache_lib
from repro_torch.models import model as model_lib
from repro_torch.models.layers import dtype_of
from repro_torch.optim import cosine_schedule, global_norm, make_optimizer
from repro_torch.weights import reference_decay_mask, reference_leaves


def _check(model, cfg):
    if model.cfg != cfg:
        raise ValueError(f"the model was built for {model.cfg.name}, the step for {cfg.name}")


def make_train_step(cfg, *, base_lr=3e-4, warmup=200, total=10000, clip=1.0):
    """``(train_step, opt_init)`` as the reference's ``make_train_step``.

    ``opt_init(model)`` is the optimizer state of the model's parameters.
    ``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``
    takes ``models.loss_fn`` and its gradient by autograd (on the card the
    mamba2 mixers run the ``ssd_intra`` forward and backward kernels), clips
    the gradients to a global norm of ``clip`` (the scale cast to each
    gradient's dtype, as the reference casts it), takes the learning rate of
    ``cosine_schedule(base_lr, warmup, total)`` at the state's step before
    it advances (so the first step, at rate 0, moves no parameter), and
    runs the config's optimizer with the reference's decay mask. The
    parameters and the optimizer state are updated in place; the model and
    the state are returned for the reference's calling form. metrics
    ``{loss, ce, aux, ppl_proxy, grad_norm, lr}`` are tensors on the
    model's device: the step makes no host sync."""
    opt_init_fn, opt_update = make_optimizer(cfg.optimizer)
    lr_fn = cosine_schedule(base_lr, warmup, total)
    factored = cfg.optimizer == "adafactor"

    def opt_init(model):
        _check(model, cfg)
        params = list(model.parameters())
        return opt_init_fn(params, reference_leaves(model)) if factored else opt_init_fn(params)

    def train_step(model, opt_state, batch):
        _check(model, cfg)
        params = list(model.parameters())
        loss, metrics = model_lib.loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params)
        gn = global_norm(grads)
        scale = torch.clamp(torch.full_like(gn, clip) / torch.clamp(gn, min=1e-9), max=1.0)
        grads = [g * scale.to(g.dtype) for g in grads]
        lr = lr_fn(opt_state["step"])
        layout = ({"leaves": reference_leaves(model)} if factored else
                  {"decay": reference_decay_mask(model)})
        _, opt_state = opt_update(grads, opt_state, params, lr, **layout)
        metrics = dict({k: v.detach() for k, v in metrics.items()}, loss=loss.detach(),
                       grad_norm=gn, lr=lr)
        return model, opt_state, metrics

    return train_step, opt_init


def make_prefill_step(cfg, attn_len: int):
    """``prefill_step(model, tokens, aux_embeds=None) -> (last_logits,
    cache)``, the cache of ``attn_len`` slots per attention layer; an
    encoder-decoder or VLM arch needs ``aux_embeds`` (B, n_aux_tokens,
    d_model)."""
    def prefill_step(model, tokens, aux_embeds=None):
        _check(model, cfg)
        return model_lib.prefill(model, tokens, attn_len=attn_len, aux_embeds=aux_embeds)
    return prefill_step


def make_serve_step(cfg):
    """``serve_step(model, cache, token, idx) -> (logits, cache)``: one
    greedy-decode step of token (B, 1) at position idx."""
    def serve_step(model, cache, token, idx):
        _check(model, cfg)
        return model_lib.decode_step(model, cache, token, idx)
    return serve_step


# ------------------------------------------------------------- input specs
def sds(shape, dtype):
    """An empty ``meta`` tensor: a leaf's shape and dtype, nothing more."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def params_spec(cfg):
    """The port's ``Model`` of ``cfg`` on ``meta``, with no draws: its
    parameters' shapes and dtypes."""
    return model_lib.Model(cfg, device="meta")


def attn_len_for(cfg, shape) -> int:
    """Allocated KV length for full-attention layers under this shape."""
    if shape.name == "long_500k":
        return cfg.long_context_window
    return shape.seq_len


def input_specs(cfg, shape_name):
    """``meta`` stand-ins for every model input of the step that this input
    shape (a name of ``INPUT_SHAPES``, or an ``InputShape``) runs: train gives ``{"batch": {"tokens", "labels"(,
    "aux_embeds")}}``, prefill ``{"tokens"(, "aux_embeds")}``, decode
    ``{"cache", "token", "idx"}`` with the port's per-layer cache of
    ``attn_len_for`` slots. ``aux_embeds`` (B, n_aux_tokens, d_model) come
    in the compute dtype where the config has them."""
    shape = INPUT_SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    b, s = shape.global_batch, shape.seq_len
    cdt = dtype_of(cfg.compute_dtype)
    aux = {"aux_embeds": sds((b, cfg.n_aux_tokens, cfg.d_model), cdt)} \
        if cfg.n_aux_tokens else {}
    if shape.kind == "train":
        return {"batch": dict({"tokens": sds((b, s), torch.int32),
                               "labels": sds((b, s), torch.int32)}, **aux)}
    if shape.kind == "prefill":
        return dict({"tokens": sds((b, s), torch.int32)}, **aux)
    cache = cache_lib.make_cache(cfg, b, attn_len_for(cfg, shape), device="meta")
    return {"cache": cache, "token": sds((b, 1), torch.int32), "idx": sds((), torch.int32)}


def long_context_applicable(cfg) -> bool:
    """long_500k needs sub-quadratic decode state. Every arch qualifies, as
    in the reference: SSM and hybrid natively, attention archs through the
    sliding-window cache variant (``cfg.long_context_window``)."""
    return True
