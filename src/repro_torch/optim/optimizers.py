"""AdamW, the port of ``src/repro/optim/optimizers.py``'s ``global_norm``,
``adamw_init`` and ``adamw_update``.

The reference is functional over a params pytree; here the parameters are a
list of tensors (an agent's ``nn.Parameter``\\ s) updated in place, and the
state ``{"m", "v", "step"}`` holds one moment tensor per parameter and the
step count as an int32 tensor on the parameters' device. The arithmetic is
the reference's: ``b2 = 0.95`` by default, bias corrections ``1 - b ** step``
computed on the device in float32, the step ``(m / bc1) / (sqrt(v / bc2) +
eps)``, and weight decay only on leaves of two or more dimensions. The
update runs as ``torch._foreach_*`` ops over all leaves at once, with no
host sync. Adafactor comes with the launch and sharding slice.
"""
from __future__ import annotations

from typing import List, Sequence

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
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    """One AdamW step: updates ``params`` and the state's moments in place
    and returns ``(params, state)`` with the state's step advanced."""
    step = state["step"] + 1
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, sf)
    bc2 = 1 - torch.pow(b2, sf)
    grads = [g.to(torch.float32) for g in grads]
    m, v = state["m"], state["v"]
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(torch._foreach_div(m, bc1), denom)
    if weight_decay:
        decay = [i for i, p in enumerate(params) if p.dim() >= 2]
        torch._foreach_add_([update[i] for i in decay],
                            torch._foreach_mul([params[i] for i in decay], weight_decay))
    torch._foreach_sub_(params, torch._foreach_mul(update, lr))
    return params, {"m": m, "v": v, "step": step}
