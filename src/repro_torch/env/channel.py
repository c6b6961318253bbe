"""Wireless uplink model (paper §3.3, Eq. 5) of ``src/repro/env/channel.py``.

Channel gain g_n = d_n^-l (path-loss exponent l = 3); the uplink rate of UE
n under interference from the other offloading UEs on its slot is
``r_n = omega * log2(1 + p_n g_n / (sigma + sum_{i != n, same slot} p_i g_i))``.
With ``route`` the slots are (server, channel) pairs of an edge pool and
omega/sigma are (E, C) (omega also (..., E, C), one per env, where the
pool's geometry is drawn per env); without it they are the (C,) channels
of one server.
Every per-UE tensor may carry leading env axes; interference stays within
an env.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def channel_gain(d, pathloss=3.0):
    return torch.pow(torch.clamp(d, min=1.0), -pathloss)


def slot_totals(onehot, x):
    """Per-slot sums of x within each env: onehot (..., N, S), x (..., N)
    -> (..., S)."""
    if x.dim() == 1:
        return onehot.T @ x
    return (x.unsqueeze(-2) @ onehot).squeeze(-2)


def uplink_rates(p, c, g, transmitting, *, omega, sigma, route=None):
    """p, g: (..., N) watts / gains; c: (..., N) int channel ids;
    transmitting: (..., N) bool. Returns (..., N) bits/s."""
    pg = p * g * transmitting
    if route is None:
        slot, n_slots = c, omega.shape[0]
        om, sg = omega[c], sigma[c]
    else:
        n_ch = omega.shape[-1]
        slot, n_slots = (route * n_ch + c).long(), omega.shape[-2] * n_ch
        sg = sigma[route, c]
        om = omega[route, c] if omega.dim() == 2 \
            else torch.gather(omega.flatten(-2), -1, slot)
    slot = slot.long()
    onehot = F.one_hot(slot, n_slots).to(pg.dtype)              # (..., N, E*C)
    per_slot = slot_totals(onehot, pg)                          # total power
    interference = torch.gather(per_slot, -1, slot) - pg        # exclude self
    sinr = (p * g) / (sg + interference)
    return om * torch.log2(1.0 + sinr)
