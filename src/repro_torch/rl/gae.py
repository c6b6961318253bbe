"""Generalized advantage estimation (paper Eq. 18), the port of
``src/repro/rl/gae.py``: a reverse loop over T on the device, with the
reference's ``nonterm`` arithmetic."""
from __future__ import annotations

import torch


def gae(rewards, values, dones, last_value, *, gamma=0.95, lam=0.95):
    """rewards, values, dones: (T, E); last_value: (E,). Returns
    (advantages, returns), each (T, E)."""
    nonterm = 1.0 - dones.to(rewards.dtype)
    v_next = torch.cat([values[1:], last_value[None]])
    delta = rewards + gamma * v_next * nonterm - values
    coef = gamma * lam * nonterm
    adv = torch.zeros_like(last_value)
    advs = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        adv = delta[t] + coef[t] * adv
        advs.append(adv)
    advs = torch.stack(advs[::-1])
    return advs, advs + values
