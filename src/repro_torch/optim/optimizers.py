"""AdamW, the port of ``src/repro/optim/optimizers.py``'s ``global_norm``,
``adamw_init`` and ``adamw_update``.

The reference is functional over a params pytree; here the parameters are a
list of tensors (an agent's or a model's ``nn.Parameter``\\ s) updated in
place, and the state ``{"m", "v", "step"}`` holds one moment tensor per
parameter and the step count as an int32 tensor on the parameters' device.
The arithmetic is the reference's: ``b2 = 0.95`` by default, bias
corrections ``1 - b ** step`` computed on the device in float32, the step
``(m / bc1) / (sqrt(v / bc2) + eps)``, and the new parameter ``p - lr *
(update + wd * p)`` in float32, rounded to the parameter's dtype once.
Weight decay takes the leaves the reference decays, those of two or more
dimensions; a caller whose leaves have other ranks than the reference's
(a model, whose blocks the reference stacks on a layer axis) passes the
mask (``weights.reference_decay_mask``). The update runs as
``torch._foreach_*`` ops over all leaves at once, with no host sync.
Adafactor comes with the model-zoo slice.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def global_norm(tree: Sequence[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all leaves together, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree))


def adamw_init(params: Sequence[torch.Tensor]):
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
    return {"m": zeros, "v": [z.clone() for z in zeros],
            "step": torch.zeros((), dtype=torch.int32, device=params[0].device)}


@torch.no_grad()
def adamw_update(grads: Sequence[torch.Tensor], state, params: List[torch.Tensor], lr, *,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                 decay: Optional[Sequence[bool]] = None):
    """One AdamW step: updates ``params`` and the state's moments in place
    and returns ``(params, state)`` with the state's step advanced.
    ``decay[i]`` says whether parameter i takes weight decay; by default
    those of two or more dimensions, the reference's rule on its leaves."""
    step = state["step"] + 1
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, sf)
    bc2 = 1 - torch.pow(b2, sf)
    grads = [g.to(torch.float32) for g in grads]
    m, v = state["m"], state["v"]
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(v, b2)
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1 - b2)
    torch._foreach_add_(v, sq)
    del sq, grads
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(m, bc1)
    torch._foreach_div_(update, denom)
    del denom
    if decay is None:
        decay = [p.dim() >= 2 for p in params]
    if len(decay) != len(params):
        raise ValueError(f"adamw_update: {len(decay)} decay flags for {len(params)} parameters")
    if weight_decay:
        idx = [i for i, d in enumerate(decay) if d]
        if idx:   # wd * p in float32, for bf16 leaves too
            torch._foreach_add_([update[i] for i in idx], torch._foreach_mul(
                [params[i].to(torch.float32) for i in idx], weight_decay))
    torch._foreach_mul_(update, lr)
    f32 = [i for i, p in enumerate(params) if p.dtype == torch.float32]
    if f32:
        torch._foreach_sub_([params[i] for i in f32], [update[i] for i in f32])
    for i, p in enumerate(params):
        if p.dtype != torch.float32:   # p - lr (update + wd p) in float32, rounded once
            p.copy_(p.to(torch.float32) - update[i])
    return params, {"m": m, "v": v, "step": step}


def make_optimizer(name: str):
    """``(init, update)`` of the optimizer a config names: ``"adamw"``.
    Adafactor (the XL archs' optimizer) comes with the model-zoo slice."""
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        raise NotImplementedError("adafactor comes with the model-zoo slice (ROADMAP queue 1, "
                                  "item 6)")
    raise ValueError(name)
