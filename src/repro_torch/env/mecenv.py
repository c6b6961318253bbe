"""Multi-agent collaborative-inference MEC environment (paper §3-4), the
port of ``src/repro/env/mecenv.py``.

State s_t = {k_t, l_t, n_t, d} (remaining tasks, remaining local seconds of
the in-flight task, its remaining offload bits, UE distances). Actions are
a dict keyed by the env's :class:`HybridActionSpace`
(``{"split", "channel", "power"}``, plus ``"route"`` with an edge pool).
Reward (Eq. 12): ``r_t = -T0 / K_t - beta * E_t / K_t``.

Each frame runs three analytic phases per UE with exact carry-over: resume
the in-flight task (local seconds, then offload bits at this frame's
rate), run ``floor(t_rem / t_task)`` whole tasks at the new split, start
one partial task whose remainder is the next state's ``(l, n)``. A
transmit remainder below ``TX_EPS_BITS`` counts as sent and is reported in
``info["eps_bits"]``. With an edge pool each offloaded whole task also
pays ``t_edge[n, b, e]`` times the number of UEs offloading to server e.

Fleets may be dynamic: with ``churn_rate`` or ``leave_rate`` above 0 a
standby UE joins with probability 1 - exp(-churn_rate) a frame and an
active one leaves with probability ``leave_rate``; ``EnvState.active``
holds the membership, N stays the largest fleet, and inactive UEs add no
interference, energy, completions or reward. A leaver drops its queue, a
joiner draws a fresh queue and distance, and the end of an episode makes
the whole fleet active again. The four churn variates of a frame come from
``_draw_churn``; a static env draws none of them, so its stream is the one
it always was. Tables are float32 where the reference casts them.

Pool geometry may be resampled per episode: an env built with
``pool_ranges`` (a multi-server pool) takes ``reset(gen,
randomize=True)``, which draws every server's [dist_scale, bw_scale,
slowness] uniformly from the ranges into ``EnvState.geom`` ((E, 3), or
(n_envs, E, 3)); the physics (distances, bandwidths, edge seconds) and the
entity observations then follow each env's own draw, and ``step`` redraws
it where an episode ends. A state without geometry (``geom`` None) runs
exactly the static graph. The state carries a
``torch.Generator`` in place of the reference's threefry key: eval-mode
reset draws nothing, a random reset and every step's auto-reset draw from
it (the reference draws its auto-reset every frame too and keeps it only
when the episode ends).

Every state leaf may carry a leading env axis: ``reset(gen, n_envs=E)``
gives (E, N) leaves (and an (E,) frame counter), and ``step``,
``observe*`` and ``task_overhead`` then work on all E envs at once, where
the reference trains on ``vmap``-batched states. Reductions run over the
UE axis only; one generator draws every env's auto-reset as one (E, N)
block. The (N,) single-env path computes as it did before the axis came.

Sharded over ranks, a state holds block ``rows`` (an
``actionspace.Rows``) of the env axis: ``reset(gen, n_envs=E, rows=...)``
gives the rank's E envs, and every draw (the reset's, churn, auto-resets,
geometry) is made for all the blocks and the rank's kept, so a rank's
envs see the numbers one process would give them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import overhead as oh
from repro_torch.core.fleets import (BITS_NORM, DIST_NORM, EDGE_SLOW_NORM,
                                     RATE_NORM, EdgePool, pool_aggregate_features,
                                     pool_geometry, ue_edge_work, ue_table_features)
from repro_torch.core.split import FleetPlan, SplitPlan
from repro_torch.env.channel import channel_gain, slot_totals, uplink_rates
from repro_torch.rl.actionspace import (ContinuousHead, DiscreteHead, HybridActionSpace, Rows,
                                        draw_rows)


class EnvParams(NamedTuple):
    l_new: torch.Tensor      # (N, B_max+2) f32 local+compression seconds per split
    n_new: torch.Tensor      # (N, B_max+2) f32 offload bits per split
    feasible: torch.Tensor   # (N, B_max+2) bool; False on padded actions
    p_compute: torch.Tensor  # (N,) f32 per-UE compute power (W)
    t0: float                # frame seconds (float32 values, kept as floats)
    beta: float
    omega: torch.Tensor      # (C,) single server, (E, C) edge pool
    sigma: torch.Tensor      # (C,) / (E, C)
    p_max: float
    lam_tasks: float         # Poisson mean of K_n
    d_low: float
    d_high: float
    n_ue: int
    pathloss: float
    churn_rate: float = 0.0
    leave_rate: float = 0.0
    server_dist: Optional[torch.Tensor] = None   # (E,) distance scale per server
    t_edge: Optional[torch.Tensor] = None        # (N, B_max+2, E) edge seconds
    pool_geom: Optional[torch.Tensor] = None     # (E, 3) [dist, bw, slowness]
    omega_cell: Optional[torch.Tensor] = None    # (C,) base channel bandwidth
    edge_work: Optional[torch.Tensor] = None     # (N, B_max+2) edge-tail FLOPs
    pool_low: Optional[torch.Tensor] = None      # (E, 3) resample range low
    pool_high: Optional[torch.Tensor] = None     # (E, 3) resample range high


# per-UE featurized observation layout (observe_per_ue): widths do not
# depend on N, B_max or E
OBS_UE_OWN = 5
OBS_UE_ACT = 1
OBS_UE_DEVICE = 5
OBS_UE_POOL = 4
OBS_UE_FLEET = 4
OBS_UE_DIM = OBS_UE_OWN + OBS_UE_ACT + OBS_UE_DEVICE + OBS_UE_POOL + OBS_UE_FLEET

# entity-set observation layout (observe_entities)
OBS_ENT_UE = OBS_UE_OWN + OBS_UE_ACT + OBS_UE_DEVICE + OBS_UE_FLEET
OBS_ENT_SRV = 4             # dist scale, bw scale, slowness, UEs per slot
OBS_ENT_EDGE = 3            # distance, clean-rate proxy, edge-service time

# A remaining offload below this many bits counts as sent (absorbs float32
# residue of n - (n / r) * r); the bits absorbed go to info["eps_bits"].
TX_EPS_BITS = 1.0


def _f32(x) -> float:
    return float(np.float32(x))


def per_ue(table, b):
    """Each UE's own table entry: table (N, B+2), b (..., N) -> (..., N)."""
    b = b.long()
    return torch.gather(table.expand(*b.shape, table.shape[-1]), -1, b[..., None])[..., 0]


def _ue_tables(plan, n_ue):
    """(t_local, feasible, peak_flops) per UE as numpy."""
    if isinstance(plan, FleetPlan):
        t_loc = np.asarray(plan.t_local, np.float64)
        feas = np.asarray(plan.feasible, bool)
        peaks = np.array([pr.device.peak_flops for pr in plan.profiles])
    else:
        t_loc = np.tile(np.asarray(plan.t_local, np.float64)[None], (n_ue, 1))
        feas = np.tile(np.asarray(plan.feasible, bool)[None], (n_ue, 1))
        dev = oh.UE_TIERS.get(plan.device, oh.JETSON_NANO) \
            if plan.device else oh.JETSON_NANO
        peaks = np.full((n_ue,), dev.peak_flops)
    return t_loc, feas, peaks


def make_env_params(plan: Union[SplitPlan, FleetPlan], *, n_ue=5,
                    n_channels=2, t0=0.5, beta=0.47, p_compute=None,
                    omega=1e6, sigma=1e-9, p_max=0.5, lam_tasks=200.0,
                    d_low=1.0, d_high=100.0, pathloss=3.0,
                    churn_rate=0.0, leave_rate=0.0,
                    pool: Optional[EdgePool] = None,
                    pool_ranges=None, device=None) -> EnvParams:
    """A SplitPlan is broadcast to ``n_ue`` identical UEs; a FleetPlan
    gives per-UE tables and power draws. An EdgePool of more than one
    server (or one non-default server) gives the routed action space;
    ``pool_ranges``, a (low, high) pair of (E, 3) bounds, makes its
    geometry resamplable (``reset(randomize=True)``). A nonzero
    ``churn_rate`` or ``leave_rate`` makes the fleet dynamic. The
    tables are built in numpy (float64), cast to float32 as the reference
    casts them, and put on ``device`` (the card unless the caller passes
    one; raises when there is no card and none was given)."""
    device = resolve_device(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    if isinstance(plan, FleetPlan):
        n_ue = plan.n_ue
        l_new = f32(plan.t_local + plan.t_comp)
        n_new = f32(plan.f_bits)
        feasible = torch.as_tensor(np.asarray(plan.feasible, bool), device=device)
        p_vec = f32(plan.p_compute if p_compute is None else np.full((n_ue,), p_compute))
    else:
        l_new = f32(np.tile((plan.t_local + plan.t_comp).astype(np.float32)[None], (n_ue, 1)))
        n_new = f32(np.tile(plan.f_bits.astype(np.float32)[None], (n_ue, 1)))
        feasible = torch.as_tensor(np.tile(np.asarray(plan.feasible, bool)[None], (n_ue, 1)),
                                   device=device)
        p_vec = f32(np.full((n_ue,), 2.1 if p_compute is None else p_compute))

    t_loc, feas_np, peaks = _ue_tables(plan, n_ue)
    work = ue_edge_work(t_loc, feas_np, peaks)       # (N, B+2) float64
    if pool is None or pool.is_single_paper_server:
        if pool_ranges is not None:
            raise ValueError("pool_ranges needs a multi-server EdgePool")
        omega_t = f32(np.full((n_channels,), np.float32(omega)))
        sigma_t = f32(np.full((n_channels,), np.float32(sigma)))
        server_dist = t_edge = None
    else:
        bw = np.array([s.bw_scale for s in pool.servers])
        omega_t = f32(bw[:, None] * np.full((n_channels,), omega))
        sigma_t = f32(np.full((pool.n_servers, n_channels), np.float32(sigma)))
        server_dist = f32([s.dist_scale for s in pool.servers])
        speed = np.array([s.edge_speed for s in pool.servers])
        t_edge = f32(work[:, :, None] / np.where(speed > 0, speed, np.inf))

    pool_low = pool_high = None
    if pool_ranges is not None:
        lo, hi = pool_ranges
        shape = (pool.n_servers, 3)
        if np.asarray(lo).shape != shape or np.asarray(hi).shape != shape:
            raise ValueError(f"pool_ranges must be (low, high) {shape} "
                             f"arrays, got {np.asarray(lo).shape}")
        pool_low, pool_high = f32(lo), f32(hi)

    return EnvParams(
        l_new=l_new, n_new=n_new, feasible=feasible, p_compute=p_vec,
        t0=_f32(t0), beta=_f32(beta), omega=omega_t, sigma=sigma_t,
        p_max=_f32(p_max), lam_tasks=_f32(lam_tasks),
        d_low=_f32(d_low), d_high=_f32(d_high), n_ue=n_ue,
        pathloss=_f32(pathloss), churn_rate=_f32(churn_rate),
        leave_rate=_f32(leave_rate), server_dist=server_dist, t_edge=t_edge,
        pool_geom=f32(pool_geometry(pool)),
        omega_cell=f32(np.full((n_channels,), np.float32(omega))),
        edge_work=f32(work), pool_low=pool_low, pool_high=pool_high)


class EnvState(NamedTuple):
    """Leaves of (N,), or (E, N) with a leading env axis (``t``: (E,),
    ``geom``: (E, n_servers, 3))."""
    k: torch.Tensor          # (N,) remaining tasks (incl. in-flight)
    l: torch.Tensor          # (N,) remaining local seconds of current task
    n: torch.Tensor          # (N,) remaining offload bits of current task
    d: torch.Tensor          # (N,) distances
    t: torch.Tensor          # frame counter (int32)
    gen: Optional[torch.Generator]   # draws of random and auto resets
    active: torch.Tensor = None      # (N,) bool membership (all True: static fleet)
    geom: Optional[torch.Tensor] = None  # (n_servers, 3) resampled geometry; None: static
    rows: Optional[Rows] = None      # the rank's block of the env axis; None: all of it


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


class MECEnv:
    """The env as plain functions on tensors, on the device of its params.
    ``multi_server`` and ``dynamic`` are fixed at construction: one
    paper-default server runs without the routing machinery, and a static
    fleet without the churn block (and its draws)."""

    def __init__(self, params: EnvParams):
        self.params = params
        self.device = params.l_new.device
        self.n_actions_b = int(params.l_new.shape[1])
        self.n_channels = int(params.omega.shape[-1])
        self.multi_server = params.omega.dim() == 2
        self.n_servers = int(params.omega.shape[0]) if self.multi_server else 1
        self.dynamic = params.churn_rate > 0.0 or params.leave_rate > 0.0
        self.ue_feat_dim = OBS_UE_DIM
        # observe: [k, l, n, d] per UE, and activity and fleet size when dynamic
        self.obs_dim = (6 if self.dynamic else 4) * params.n_ue
        dev = self.device
        self._ue_static = torch.as_tensor(ue_table_features(
            _np(params.l_new), _np(params.n_new), _np(params.feasible),
            _np(params.p_compute), params.t0), device=dev)
        self._pool_static = torch.as_tensor(pool_aggregate_features(
            _np(params.server_dist), _np(params.omega), _np(params.t_edge),
            _np(params.feasible), params.t0), device=dev)
        self._min_dist_scale = 1.0 if params.server_dist is None \
            else float(_np(params.server_dist).min())
        self.randomizable = params.pool_low is not None
        self.entity_dims = {"ue": OBS_ENT_UE, "server": OBS_ENT_SRV,
                            "edge": OBS_ENT_EDGE}
        self._srv_scale = torch.tensor([1.0, 1.0, 1.0 / EDGE_SLOW_NORM], device=dev)
        work = _np(params.edge_work).astype(np.float64)
        offl_feas = _np(params.feasible)[:, :-1]
        cnt = np.maximum(offl_feas.sum(axis=1), 1)
        self._ue_work_mean = torch.as_tensor(
            ((work[:, :-1] * offl_feas).sum(axis=1) / cnt).astype(np.float32), device=dev)
        # physics constants of the fused pair scorer (layout in
        # kernels/pair_scorer.py), float32 steps as the reference's jnp ones
        n_srv = int(params.pool_geom.shape[0])
        self._scorer_consts = torch.stack([
            torch.tensor(params.pathloss), torch.tensor(params.p_max),
            params.sigma.float().cpu().mean(),
            params.omega_cell.float().cpu().mean() / RATE_NORM,
            torch.tensor(params.t0), torch.tensor(float(n_srv * self.n_channels)),
            torch.tensor(DIST_NORM), torch.tensor(1.0 / EDGE_SLOW_NORM),
        ]).to(torch.float32).to(dev)
        discrete = [DiscreteHead("split", self.n_actions_b),
                    DiscreteHead("channel", self.n_channels)]
        if self.multi_server:
            discrete.append(DiscreteHead("route", self.n_servers))
        self.action_space = HybridActionSpace(
            discrete=tuple(discrete),
            continuous=(ContinuousHead("power", 1e-4, params.p_max),),
            masks={"split": params.feasible})

    def reset(self, gen: Optional[torch.Generator] = None, *, eval_mode=False,
              randomize=False, n_envs: Optional[int] = None,
              rows: Optional[Rows] = None) -> EnvState:
        """Eval mode: k = lam_tasks and d = 50 m for every UE, nothing
        drawn. Otherwise k ~ Poisson(lam_tasks), d ~ U(d_low, d_high), from
        ``gen`` (on the env's device). ``gen`` stays on the state for the
        auto-resets of ``step``. ``n_envs`` gives every leaf a leading env
        axis of that length, each env drawn from the same ``gen``.
        ``randomize=True`` (needs ``pool_ranges``) first draws each env's
        pool geometry from ``gen`` (nothing else draws without it).
        ``rows`` makes the ``n_envs`` envs block ``rows.index`` of
        ``rows.count`` such blocks: every draw, here and in ``step``, is
        made for all of them and this block's kept."""
        p = self.params
        dev = self.device
        if rows is not None and n_envs is None:
            raise ValueError("rows shard the env axis: give n_envs")
        shape = (p.n_ue,) if n_envs is None else (n_envs, p.n_ue)
        geom = None
        if randomize:
            if not self.randomizable:
                raise ValueError("randomize=True needs pool_ranges")
            if gen is None:
                raise ValueError("a randomized reset needs a torch.Generator")
            geom = draw_rows(rows, lambda lead: self._draw_geom(gen, lead), shape[:-1])
        if eval_mode:
            k = torch.full(shape, p.lam_tasks, dtype=torch.float32, device=dev)
            d = torch.full(shape, 50.0, dtype=torch.float32, device=dev)
        else:
            if gen is None:
                raise ValueError("a random reset needs a torch.Generator")
            k, d = draw_rows(rows, lambda sh: self._draw_tasks(gen, sh), shape)
        zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
        return EnvState(k=k, l=zeros, n=zeros.clone(), d=d,
                        t=torch.zeros(shape[:-1], dtype=torch.int32, device=dev), gen=gen,
                        active=torch.ones(shape, dtype=torch.bool, device=dev), geom=geom,
                        rows=rows)

    def _draw_geom(self, gen, lead):
        """(*lead, E, 3) geometry, uniform in [pool_low, pool_high)."""
        p = self.params
        u = torch.rand((*lead, *p.pool_low.shape), generator=gen, device=self.device)
        return p.pool_low + u * (p.pool_high - p.pool_low)

    def _geom(self, s: EnvState):
        """The state's pool geometry: its draw, else the construction-time
        (E, 3) one."""
        return self.params.pool_geom if s.geom is None else s.geom

    def _pool_phys(self, s: EnvState):
        """None on the static path (the physics read the params' arrays);
        with drawn geometry the (server_dist (..., E), omega (..., E, C),
        t_edge (..., N, B+2, E)) of each env's draw."""
        if not self.multi_server or s.geom is None:
            return None
        p = self.params
        omega = s.geom[..., 1, None] * p.omega_cell
        # service time is linear in the drawn slowness (0 = instant edge)
        t_edge = p.edge_work[:, :, None] * s.geom[..., None, None, :, 2]
        return s.geom[..., 0], omega, t_edge

    def _draw_tasks(self, gen, shape):
        p = self.params
        rate = torch.full(shape, p.lam_tasks, dtype=torch.float32, device=self.device)
        k = torch.poisson(rate, generator=gen)
        u = torch.rand(shape, generator=gen, device=self.device)
        return k, p.d_low + u * (p.d_high - p.d_low)

    def _draw_churn(self, gen, shape):
        """A frame's churn variates: (u_join, u_leave) uniform in [0, 1), a
        fresh queue ~ Poisson(lam_tasks) and a fresh distance ~ U(d_low,
        d_high), each of ``shape``."""
        u_join = torch.rand(shape, generator=gen, device=self.device)
        u_leave = torch.rand(shape, generator=gen, device=self.device)
        return (u_join, u_leave) + self._draw_tasks(gen, shape)

    def observe(self, s: EnvState):
        """The per-UE actors' flat global observation, (..., obs_dim):
        ``[k / lam, l / t0, n / 1e6, d / 100]``, each block over the UEs,
        then for a dynamic fleet the activity flags and the active fraction
        (repeated N times)."""
        p = self.params
        base = [s.k / max(p.lam_tasks, 1.0), s.l / p.t0, s.n / 1e6, s.d / 100.0]
        if self.dynamic:
            act = s.active.to(torch.float32)
            base += [act, (act.sum(-1, keepdim=True) / p.n_ue).expand_as(act)]
        return torch.cat(base, dim=-1)

    def _own_fleet(self, s: EnvState, min_dist_scale, n_slots):
        """The own block (..., N, 5) and the fleet aggregates (..., 4)
        shared by the per-UE and entity observations."""
        p = self.params
        act = s.active.to(torch.float32)
        lam = max(p.lam_tasks, 1.0)
        own = torch.stack([
            s.k / lam,
            s.l / p.t0,
            s.n / BITS_NORM,
            s.d / DIST_NORM,
            s.d * min_dist_scale / DIST_NORM,
        ], dim=-1) * act[..., None]
        n_act = torch.clamp(act.sum(-1), min=1.0)
        per_slot = act.sum(-1) / n_slots
        fleet = torch.stack([
            act.sum(-1) / p.n_ue,
            (s.k * act).sum(-1) / (n_act * lam),
            (s.d * act).sum(-1) / (n_act * DIST_NORM),
            per_slot,
        ], dim=-1)
        return own, act, fleet, per_slot

    def observe_per_ue(self, s: EnvState):
        """(..., N, OBS_UE_DIM) rows for a weight-shared policy: own state
        (5), activity (1), device descriptor (5), pool aggregate (4), fleet
        aggregates (4)."""
        own, act, fleet, _ = self._own_fleet(s, self._min_dist_scale,
                                             self.n_servers * self.n_channels)
        rows = own.shape[:-1]
        return torch.cat([
            own, act[..., None], self._ue_static.expand(*rows, OBS_UE_DEVICE),
            self._pool_static.expand(*rows, OBS_UE_POOL),
            fleet[..., None, :].expand(*rows, OBS_UE_FLEET),
        ], dim=-1)

    def _ue_rows(self, s: EnvState, geom):
        nearest = geom[..., 0].amin(-1)
        if nearest.dim():                   # one scale per env: (E, 1)
            nearest = nearest[..., None]
        own, act, fleet, per_slot = self._own_fleet(
            s, nearest, geom.shape[-2] * self.n_channels)
        rows = own.shape[:-1]
        ue = torch.cat([own, act[..., None], self._ue_static.expand(*rows, OBS_UE_DEVICE),
                        fleet[..., None, :].expand(*rows, OBS_UE_FLEET)], dim=-1)
        return ue, act, per_slot

    def observe_entities(self, s: EnvState):
        """Entity-set observation {"ue": (..., N, 15), "server": (..., E,
        4), "edge": (..., N, E, 3)}: UE rows, server geometry plus
        occupancy, and UE x server distance, clean-rate proxy and edge
        seconds, all from the state's geometry."""
        p = self.params
        geom = self._geom(s)
        n_srv = geom.shape[-2]
        ue, _, per_slot = self._ue_rows(s, geom)
        lead = per_slot.shape
        srv = torch.cat([
            (geom * self._srv_scale).expand(*lead, n_srv, 3),
            per_slot[..., None, None].expand(*lead, n_srv, 1),
        ], dim=-1)
        dist_ne = s.d[..., None] * geom[..., None, :, 0]
        g_ne = channel_gain(dist_ne, p.pathloss)
        om_mean = geom[..., None, :, 1] * p.omega_cell.mean()
        rate = om_mean * torch.log2(1.0 + p.p_max * g_ne / p.sigma.mean()) / RATE_NORM
        te = (self._ue_work_mean[:, None] * geom[..., None, :, 2] / p.t0).expand_as(dist_ne)
        edge = torch.stack([dist_ne / DIST_NORM, rate, te], dim=-1)
        return {"ue": ue, "server": srv, "edge": edge}

    def observe_entities_raw(self, s: EnvState):
        """Kernel-path variant of ``observe_entities``: the same UE rows,
        and in place of the (N, E, 3) edge block the raw per-UE vectors,
        the geometry and the physics constants ``kernels.ops.pair_scorer``
        takes. With an env axis every raw leaf carries it, as the
        reference's ``vmap`` gives them."""
        geom = self._geom(s)
        ue, act, _ = self._ue_rows(s, geom)
        lead = s.d.shape[:-1]
        return {"ue": ue, "raw": {
            "d": s.d, "work": self._ue_work_mean.expand(s.d.shape), "active": act,
            "geom": geom.expand(*lead, *geom.shape[-2:]),
            "consts": self._scorer_consts.expand(*lead, -1)}}

    def action_masks(self, s: EnvState = None):
        """{head: (N, n) bool}: the split head's per-UE table feasibility.
        Given a state of a dynamic fleet, inactive UEs may take only
        full-local (the last action), and the mask takes the state's leading
        env axis: (..., N, n)."""
        feas = self.action_space.masks["split"]
        if s is None or not self.dynamic:
            return {"split": feas}
        local_only = torch.zeros_like(feas)
        local_only[:, -1] = True
        return {"split": torch.where(s.active[..., None], feas, local_only)}

    # ------------------------------------------------------------ physics
    def _rates(self, d, c, p_tx, route, transmitting, phys=None):
        """Uplink rates; ``phys`` (``_pool_phys``) replaces the static
        pool's distances and bandwidths with each env's draw."""
        prm = self.params
        if self.multi_server:
            dist, omega = (prm.server_dist, prm.omega) if phys is None else phys[:2]
            scale = dist[route] if dist.dim() == 1 else torch.gather(dist, -1, route)
            g = channel_gain(d * scale, prm.pathloss)
            r = uplink_rates(p_tx, c, g, transmitting, omega=omega,
                             sigma=prm.sigma, route=route)
        else:
            g = channel_gain(d, prm.pathloss)
            r = uplink_rates(p_tx, c, g, transmitting, omega=prm.omega, sigma=prm.sigma)
        return torch.clamp(r, min=1.0)   # 1 b/s floor

    def _edge_seconds(self, b, route, offloads, phys=None):
        """Per-task edge time under processor sharing: t_edge[n, b, e]
        times the number of UEs (of the same env) offloading to e."""
        prm = self.params
        t_edge = prm.t_edge if phys is None else phys[2]
        ue = torch.arange(prm.n_ue, device=b.device)
        if t_edge.dim() == 3:
            te = t_edge[ue, b, route]
        else:                               # a table per env: (envs, N, B+2, servers)
            te = t_edge[torch.arange(b.shape[0], device=b.device)[:, None], ue, b, route]
        load = slot_totals(F.one_hot(route, self.n_servers).to(te.dtype),
                           offloads.to(te.dtype))
        return te * torch.clamp(torch.gather(load, -1, route), min=1.0), load

    def step(self, s: EnvState, actions):
        """actions: (..., N) int per discrete head, (..., N) physical watts
        for "power" (clamped here), with the state's leading env axis.
        Returns (next_state, reward, done, info), all tensors on the env's
        device; reward, done and the info scalars are per env."""
        prm = self.params
        a = self.action_space.clip(actions)
        b, c, p_tx = a["split"].long(), a["channel"].long(), a["power"]
        route = a["route"].long() if self.multi_server else None
        phys = self._pool_phys(s)
        act = s.active
        has_work = (s.k > 0) & act
        l_new = per_ue(prm.l_new, b)
        n_new = per_ue(prm.n_new, b)
        offloads = ((s.n > 0) | (n_new > 0)) & has_work
        r = self._rates(s.d, c, p_tx, route, offloads, phys)
        hw = has_work.to(torch.float32)

        t_rem = torch.full_like(s.l, prm.t0)
        energy = torch.zeros_like(s.l)
        completed = torch.zeros_like(s.l)

        # phase 1: the carried task, resumed where the last frame left it
        dt_l = torch.minimum(s.l, t_rem) * hw
        t_rem = t_rem - dt_l
        energy = energy + dt_l * prm.p_compute
        l1 = s.l - dt_l
        tx_time = torch.where(l1 <= 0, torch.minimum(s.n / r, t_rem), 0.0) * hw
        n1 = s.n - tx_time * r
        eps_bits = torch.clamp(n1, min=0.0) * (n1 < TX_EPS_BITS)
        n1 = torch.where(n1 < TX_EPS_BITS, 0.0, n1)
        t_rem = t_rem - tx_time
        energy = energy + tx_time * p_tx
        carried = has_work & (s.l + s.n > 0)
        done_carry = carried & (l1 <= 0) & (n1 <= 0)
        carry_open = carried & ~done_carry
        completed = completed + done_carry
        k1 = s.k - done_carry.to(torch.float32)

        # phase 2: whole new tasks at the new split b
        t_task = l_new + n_new / r
        server_load = None
        if self.multi_server:
            te_eff, server_load = self._edge_seconds(b, route, offloads, phys)
            t_task = t_task + te_eff
        can = (k1 > 0) & (t_task > 0) & act
        m = torch.where(can, torch.floor(t_rem / torch.clamp(t_task, min=1e-9)), 0.0)
        m = torch.minimum(m, k1)
        completed = completed + m
        k2 = k1 - m
        t_rem = t_rem - m * t_task
        energy = energy + m * (l_new * prm.p_compute + (n_new / r) * p_tx)

        # phase 3: start one partial task (it must have some work)
        start = (k2 > 0) & (t_rem > 0) & (l_new + n_new > 0) & act
        st = start.to(torch.float32)
        dt_l2 = torch.minimum(l_new, t_rem) * st
        t_rem2 = t_rem - dt_l2
        energy = energy + dt_l2 * prm.p_compute
        l2 = torch.where(start, l_new - dt_l2, 0.0)
        tx2 = torch.where(start & (l2 <= 0), torch.minimum(n_new / r, t_rem2), 0.0)
        n2 = torch.where(start, n_new - tx2 * r, 0.0)
        eps_bits = eps_bits + torch.clamp(n2, min=0.0) * st * (n2 < TX_EPS_BITS)
        n2 = torch.where(n2 < TX_EPS_BITS, 0.0, n2)
        energy = energy + tx2 * p_tx
        finished_partial = start & (l2 <= 0) & (n2 <= 0)
        completed = completed + finished_partial
        k3 = k2 - finished_partial.to(torch.float32)
        l2 = torch.where(finished_partial, 0.0, l2)
        n2 = torch.where(finished_partial, 0.0, n2)

        # the open carry-over's remainder takes precedence (it left t_rem 0)
        l_nxt = torch.where(carry_open, l1, l2)
        n_nxt = torch.where(carry_open, n1, n2)

        k_t = completed.sum(-1)
        e_t = energy.sum(-1)
        k_div = torch.clamp(k_t, min=1.0)
        # a tensor numerator: ``scalar / tensor`` would multiply by 1 / k
        reward = torch.full_like(k_div, -prm.t0) / k_div - prm.beta * e_t / k_div

        # churn: leavers drop their queue, joiners draw a fresh queue and
        # distance (a static fleet draws nothing here)
        spawned = dropped = torch.zeros_like(k_t)
        d_next, act_next = s.d, act
        if self.dynamic:
            u_join, u_leave, k_fresh, d_fresh = draw_rows(
                s.rows, lambda sh: self._draw_churn(s.gen, sh), k3.shape)
            p_join = float(np.float32(1.0) - np.exp(np.float32(-prm.churn_rate)))  # float32
            joins = ~act & (u_join < p_join)
            leaves = act & (u_leave < prm.leave_rate)
            dropped = (k3 * leaves).sum(-1)
            spawned = (k_fresh * joins).sum(-1)
            k3 = torch.where(leaves, 0.0, torch.where(joins, k_fresh, k3))
            moved = leaves | joins
            l_nxt = torch.where(moved, 0.0, l_nxt)
            n_nxt = torch.where(moved, 0.0, n_nxt)
            d_next = torch.where(joins, d_fresh, s.d)
            act_next = (act & ~leaves) | joins

        done = torch.all(k3 <= 0, dim=-1)
        # auto-reset on termination, drawn every frame as the reference does
        fresh_k, fresh_d = draw_rows(s.rows, lambda sh: self._draw_tasks(s.gen, sh), k3.shape)
        zeros = torch.zeros_like(k3)
        dn = done[..., None]
        geom = s.geom
        if geom is not None:                # redrawn where the episode ended
            geom = torch.where(done[..., None, None], draw_rows(
                s.rows, lambda lead: self._draw_geom(s.gen, lead), done.shape), geom)
        nxt = EnvState(
            k=torch.where(dn, fresh_k, k3),
            l=torch.where(dn, zeros, l_nxt),
            n=torch.where(dn, zeros, n_nxt),
            d=torch.where(dn, fresh_d, d_next),
            t=torch.where(done, torch.zeros_like(s.t), s.t + 1),
            gen=s.gen,
            # the whole fleet is active again after an auto-reset
            active=torch.where(dn, torch.ones_like(act), act_next), geom=geom, rows=s.rows)
        info = {"completed": k_t, "energy": e_t, "rate_mean": r.mean(-1),
                "offloads": offloads.sum(-1), "n_active": act.sum(-1),
                "spawned": spawned, "dropped": dropped, "eps_bits": eps_bits.sum(-1)}
        if self.multi_server:
            info["server_load"] = server_load
        return nxt, reward, done, info

    def task_overhead(self, s: EnvState, actions):
        """Realized per-task latency and energy vectors (Eq. 7/8) of each
        UE under this frame's joint interference and, with a pool, the
        routed servers' shared compute."""
        prm = self.params
        a = self.action_space.clip(actions)
        b, c, p_tx = a["split"].long(), a["channel"].long(), a["power"]
        route = a["route"].long() if self.multi_server else None
        phys = self._pool_phys(s)
        l_b = per_ue(prm.l_new, b)
        n_b = per_ue(prm.n_new, b)
        offl = (n_b > 0) & s.active
        r = self._rates(s.d, c, p_tx, route, offl, phys)
        te_eff = None
        if self.multi_server:
            te_eff, _ = self._edge_seconds(b, route, offl, phys)
        return oh.task_latency_energy(l_b, n_b, r, prm.p_compute, p_tx, te_eff)
