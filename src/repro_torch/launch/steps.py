"""Step builders of the port (``src/repro/launch/steps.py``): the training,
prefill and serve closures over a ModelConfig, and the dry-run's input
specs: ``meta`` tensors standing in for every input of the step an input
shape runs, as the reference's ``ShapeDtypeStruct`` leaves do (nothing is
allocated or executed on ``meta``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.models import cache as cache_lib
from repro_torch.models import meshctx
from repro_torch.models import model as model_lib
from repro_torch.models.layers import dtype_of
from repro_torch.optim import cosine_schedule, global_norm, make_optimizer
from repro_torch.optim.optimizers import cut_axes, flat_passes
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
    model's device: the step makes no host sync.

    Run inside ``meshctx.use_mesh(mesh)`` on a model built under it, it is
    one rank's step, on its rows of the batch: ``loss_fn`` is the global
    loss on every rank; each rank differentiates ``loss / mesh.size`` (the
    ranks' seeds sum to one) through the mesh's collectives, whose
    backwards carry the gradient between ranks (``launch.mesh``); then
    ``sync_grads`` sums each gradient over the axes that replicate its
    block, ``global_norm`` counts each element once, and the optimizer
    updates the rank's blocks and its state, ``opt_init(model)`` being the
    rank's block of the reference's state. The metrics are the global
    ones."""
    opt_init_fn, opt_update = make_optimizer(cfg.optimizer)
    lr_fn = cosine_schedule(base_lr, warmup, total)
    factored = cfg.optimizer == "adafactor"

    def opt_init(model):
        _check(model, cfg)
        params = list(model.parameters())
        return opt_init_fn(params, reference_leaves(model)) if factored else opt_init_fn(params)

    def train_step(model, opt_state, batch):
        _check(model, cfg)
        mesh = meshctx.get_mesh()
        params = list(model.parameters())
        loss, metrics = model_lib.loss_fn(model, batch)
        if mesh is None:
            grads = [g.contiguous() for g in torch.autograd.grad(loss, params)]
            gn = global_norm(grads)
        else:
            grads = sync_grads(torch.autograd.grad(loss / mesh.size, params), params, mesh)
            gn = global_norm(grads, [getattr(p, "spec", None) for p in params], mesh)
        scale = torch.clamp(torch.full_like(gn, clip) / torch.clamp(gn, min=1e-9), max=1.0)
        for g in grads:     # the step's own gradients, clipped in place
            g.mul_(scale.to(g.dtype))
        lr = lr_fn(opt_state["step"])
        layout = ({"leaves": reference_leaves(model), "mesh": mesh} if factored else
                  {"decay": reference_decay_mask(model)})
        _, opt_state = opt_update(grads, opt_state, params, lr, **layout)
        metrics = dict({k: v.detach() for k, v in metrics.items()}, loss=loss.detach(),
                       grad_norm=gn, lr=lr)
        return model, opt_state, metrics

    return train_step, opt_init


def sync_grads(grads, params, mesh):
    """Each gradient of a rank's blocks summed over the axes of ``mesh``
    (of more than one rank) that do not cut its parameter (``p.spec``):
    the ranks that hold the same block each hold their share of its
    gradient. A dim cut over an axis was summed over it already, by the
    reduce-scatter of its gather's backward. For each set of axes and
    dtype the gradients are concatenated into flat buffers of at most
    ``PASS_ELEMENTS`` (``optim.flat_passes``), one all-reduce a buffer,
    and the sums are copied back into them."""
    grads = [g.contiguous() for g in grads]
    groups = {}
    for i, (g, p) in enumerate(zip(grads, params)):
        cut = cut_axes(getattr(p, "spec", None))
        axes = tuple(a for a in mesh.axis_names if a not in cut and mesh.shape[a] > 1)
        if axes:
            groups.setdefault((axes, g.dtype), []).append(i)
    for (axes, _), idx in groups.items():
        for run in flat_passes([grads[i].numel() for i in idx]):
            parts = [grads[idx[j]].view(-1)[a:b] for j, a, b in run]
            flat = mesh.all_reduce(torch.cat(parts), axes)
            for part, summed in zip(parts, flat.split([t.numel() for t in parts])):
                part.copy_(summed)
    return grads


def make_prefill_step(cfg, attn_len: int):
    """``prefill_step(model, tokens, aux_embeds=None) -> (last_logits,
    cache)``, the cache of ``attn_len`` slots per attention layer; an
    encoder-decoder or VLM arch needs ``aux_embeds`` (B, n_aux_tokens,
    d_model). Run inside ``meshctx.use_mesh(mesh)`` it is the program of
    one rank of the mesh, on its shard of the tokens, holding its blocks
    of the cache; so is the serve step's."""
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


def local_batch(batch, mesh=None) -> int:
    """The rows of a global ``batch`` one rank of ``mesh`` holds: the
    batch over the data axes where they divide it, else all of it (the
    reference's ``batch_shardings``)."""
    if mesh is None:
        return batch
    dp = meshctx.dp_size(mesh)
    return batch // dp if batch % dp == 0 else batch


def input_specs(cfg, shape_name, mesh=None):
    """``meta`` stand-ins for every model input of the step that this input
    shape (a name of ``INPUT_SHAPES``, or an ``InputShape``) runs: train gives ``{"batch": {"tokens", "labels"(,
    "aux_embeds")}}``, prefill ``{"tokens"(, "aux_embeds")}``, decode
    ``{"cache", "token", "idx"}`` with the port's per-layer cache of
    ``attn_len_for`` slots. ``aux_embeds`` (B, n_aux_tokens, d_model) come
    in the compute dtype where the config has them. Under ``mesh`` (a
    process or counting mesh) each is the shard one rank holds: its rows of
    the batch (``local_batch``) and its block of every cache leaf
    (``cache.make_cache``)."""
    shape = INPUT_SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    s = shape.seq_len
    b = local_batch(shape.global_batch, mesh)
    cdt = dtype_of(cfg.compute_dtype)
    aux = {"aux_embeds": sds((b, cfg.n_aux_tokens, cfg.d_model), cdt)} \
        if cfg.n_aux_tokens else {}
    if shape.kind == "train":
        return {"batch": dict({"tokens": sds((b, s), torch.int32),
                               "labels": sds((b, s), torch.int32)}, **aux)}
    if shape.kind == "prefill":
        return dict({"tokens": sds((b, s), torch.int32)}, **aux)
    cache = cache_lib.make_cache(cfg, shape.global_batch, attn_len_for(cfg, shape),
                                 device="meta", mesh=mesh)
    return {"cache": cache, "token": sds((b, 1), torch.int32), "idx": sds((), torch.int32)}


def long_context_applicable(cfg) -> bool:
    """long_500k needs sub-quadratic decode state. Every arch qualifies, as
    in the reference: SSM and hybrid natively, attention archs through the
    sliding-window cache variant (``cfg.long_context_window``)."""
    return True
