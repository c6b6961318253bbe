"""Non-RL scheduler baselines, the port of ``src/repro/rl/heuristics.py``:

* greedy: each UE independently picks the argmin over its own split table
  (and, on an edge pool, over (split, server) pairs) assuming a clean
  channel at max power and round-robin channels (per server), then is
  scored jointly with interference;
* oracle_static: exhaustive search over joint (b, c[, e]) assignments at
  max power for small N, each UE's b over its own feasible set.

The env's physics run on its device; the tables and the search's
bookkeeping are numpy, as in the reference. The fixed-routing policies are
in ``rl.baselines``.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from repro_torch.core.overhead import task_latency_energy
from repro_torch.env.mecenv import MECEnv, per_ue

ORACLE_CHUNK = 4096        # joint actions the oracle scores in one batched call


def _joint_overhead(env: MECEnv, b, c, p, d, active=None, route=None):
    """Per-task latency and energy of each UE under joint actions (Eq. 7/8,
    ``core.overhead.task_latency_energy``), as float32 numpy. b, c, p, d,
    route: (..., N); leading axes score several joint actions at once.
    ``active`` (N,) bool: inactive UEs neither transmit nor interfere;
    ``route``: the target servers on a pool (default 0)."""
    prm, dev = env.params, env.device
    b = torch.as_tensor(np.asarray(b), dtype=torch.long, device=dev)
    l_b = per_ue(prm.l_new, b)
    n_b = per_ue(prm.n_new, b)
    offl = n_b > 0
    if active is not None:
        offl = offl & torch.as_tensor(np.asarray(active, bool), device=dev)
    e_route = None
    if env.multi_server:
        e_route = torch.zeros_like(b) if route is None else \
            torch.as_tensor(np.asarray(route), dtype=torch.long, device=dev)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    p = f32(p)
    r = env._rates(f32(d), torch.as_tensor(np.asarray(c), dtype=torch.long, device=dev), p,
                   e_route, offl)
    te_eff = None
    if env.multi_server:
        te_eff, _ = env._edge_seconds(b, e_route, offl)
    t, e = task_latency_energy(l_b, n_b, r, prm.p_compute, p, te_eff)
    return t.cpu().numpy(), e.cpu().numpy()


def clean_rate(env: MECEnv, d=50.0, server=None):
    """Clean-channel rate of a lone UE at p_max on channel 0 (of ``server``
    on a pool): the rate a non-coordinating heuristic plans with."""
    prm, dev = env.params, env.device
    if env.multi_server and server is None:
        raise ValueError("multi-server env: pass the target server index")
    pp = torch.full((1,), prm.p_max, dtype=torch.float32, device=dev)
    cc = torch.zeros((1,), dtype=torch.long, device=dev)
    tx = torch.ones((1,), dtype=torch.bool, device=dev)
    dd = torch.full((1,), np.float32(d), dtype=torch.float32, device=dev)
    route = None if server is None else torch.full((1,), server, dtype=torch.long, device=dev)
    return float(env._rates(dd, cc, pp, route, tx)[0])


def _clean_cost_table(env: MECEnv, d=50.0):
    """(N, B+2) single-server, or (N, B+2, E) on a pool, per-task cost t +
    beta e of each (ue, split[, server]) under a clean channel at p_max;
    infeasible cells are +inf."""
    prm = env.params
    beta = np.float32(prm.beta)
    feas = prm.feasible.cpu().numpy()
    l_new = prm.l_new.cpu().numpy()
    n_new = prm.n_new.cpu().numpy()
    p_comp = prm.p_compute.cpu().numpy()[:, None]
    p_max = np.float32(prm.p_max)

    def cell_cost(r, t_extra=np.float32(0.0)):
        r = np.float32(r)
        t = l_new + n_new / r + t_extra
        e = l_new * p_comp + n_new / r * p_max
        return np.where(feas, t + beta * e, np.inf)

    if not env.multi_server:
        return cell_cost(clean_rate(env, d))
    te = prm.t_edge.cpu().numpy()                      # (N, B+2, E)
    return np.stack([cell_cost(clean_rate(env, d, e), te[:, :, e])
                     for e in range(env.n_servers)], axis=-1)


def _round_robin_channels(route, n_channels):
    """Round-robin channel assignment within each UE's target server."""
    counts = {}
    c = []
    for e in route:
        c.append(counts.get(e, 0) % n_channels)
        counts[e] = counts.get(e, 0) + 1
    return c


def _scores(env, act, t, e):
    """The reports' means over the active UEs, as the reference takes them
    (float32 numpy means)."""
    beta = np.float32(env.params.beta)
    return {"t_task": float(t[act].mean()), "e_task": float(e[act].mean()),
            "overhead": float((t + beta * e)[act].mean())}


def _active(n, active):
    act = np.ones((n,), bool) if active is None else np.asarray(active, bool)
    if not act.any():
        raise ValueError("active mask selects no UE: nothing to score")
    return act


def greedy_eval(env: MECEnv, *, d=50.0, active=None):
    """Interference-oblivious greedy, then evaluated with interference. On
    a pool each UE picks its best (split, server) pair. ``active`` (N,)
    bool restricts the report to those UEs; the others do not interfere."""
    prm = env.params
    n = prm.n_ue
    act = _active(n, active)
    cost = _clean_cost_table(env, d)
    route = None
    if env.multi_server:
        flat = cost.reshape(n, -1).argmin(axis=1)     # over (b, e) pairs
        b = [int(x) for x in flat // env.n_servers]
        route = [int(x) for x in flat % env.n_servers]
        c = _round_robin_channels(route, env.n_channels)
    else:
        b = [int(x) for x in np.argmin(cost, axis=1)]
        c = [i % env.n_channels for i in range(n)]
    p = [float(prm.p_max)] * n
    t, e = _joint_overhead(env, b, c, p, [d] * n, active=act, route=route)
    out = {"b": b, **_scores(env, act, t, e)}
    if route is not None:
        out["route"] = route
    return out


def oracle_static_eval(env: MECEnv, *, d=50.0, max_joint=300_000, active=None):
    """Exhaustive joint search over (b, c[, e]) per UE at p_max (small N
    only), in the reference's enumeration order with its strict ``<``, so a
    tie keeps the first combination. The combinations are scored
    ``ORACLE_CHUNK`` at a time through the env's batched axis. With
    ``active``, standby UEs are pinned to full-local and only active UEs
    are searched and scored."""
    prm = env.params
    n = prm.n_ue
    beta = np.float32(prm.beta)
    act = _active(n, active)
    feas_np = prm.feasible.cpu().numpy()
    b_local = env.n_actions_b - 1
    per_ue_feas = [list(np.where(feas_np[ue])[0]) if act[ue] else [b_local]
                   for ue in range(n)]
    n_c, n_e = env.n_channels, env.n_servers
    n_ce = n_c * n_e
    # standby UEs do not transmit: one combination each
    spaces = [len(f) * (n_ce if act[ue] else 1) for ue, f in enumerate(per_ue_feas)]
    if math.prod(spaces) > max_joint:
        raise ValueError(f"joint space too large: {spaces}")
    feas_idx = [np.asarray(f) for f in per_ue_feas]
    combos = itertools.product(*(range(sp) for sp in spaces))
    best = None
    while True:
        chunk = np.array(list(itertools.islice(combos, ORACLE_CHUNK)), dtype=np.int64)
        if chunk.size == 0:
            break
        chunk = chunk.reshape(-1, n)
        on = act[None, :]
        b = np.stack([feas_idx[ue][chunk[:, ue] // n_ce if act[ue] else 0 * chunk[:, ue]]
                      for ue in range(n)], axis=1)
        c = np.where(on, (chunk % n_ce) // n_e, 0)
        e = np.where(on, chunk % n_e, 0)
        k = len(chunk)
        t, en = _joint_overhead(env, b, c, np.full((k, n), prm.p_max, np.float32),
                                np.full((k, n), d, np.float32), active=act,
                                route=e if env.multi_server else None)
        cost = (t + beta * en)[:, act].mean(axis=1)
        i = int(np.argmin(cost))          # the first of the chunk's least
        if best is None or cost[i] < best["overhead"]:
            best = {"b": [int(x) for x in b[i]], "c": [int(x) for x in c[i]],
                    "t_task": float(t[i][act].mean()), "e_task": float(en[i][act].mean()),
                    "overhead": float(cost[i])}
            if env.multi_server:
                best["route"] = [int(x) for x in e[i]]
    return best
