"""Learning-rate schedules, the port of ``src/repro/optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, warmup: int, total: int, min_ratio: float = 0.1):
    """``lr(step)``: a linear warmup from 0 over ``warmup`` steps, then a
    cosine from ``base_lr`` down to ``min_ratio * base_lr`` at ``total``.
    Computed in float32 on the step tensor's device with the reference's
    operations in its order, so it gives the reference's bits; note that
    the rate at step 0 is 0."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=step.device)
        warm = base_lr * torch.minimum(step / max(warmup, 1), f32(1.0))
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr
