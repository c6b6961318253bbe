"""Stream state -> frame policy bridge, and the baseline dispatchers; the
port of ``src/repro/stream/adapter.py``.

A dispatcher is any callable ``(core, ue) -> {"split", "channel"
[, "route"], "power"}`` returning physical actions (watts, not the
pre-squash u) for the one UE whose task is being started.
:class:`EntityDispatcher` renders the stream's live state as an
``EnvState`` snapshot (:func:`stream_env_state`), runs the frozen
frame-trained entity policy through the ``evaluate_policy`` act path
(``observe_entities`` -> ``entity_actor_forward`` -> masked ``mode`` or
``sample`` -> ``execute``) and takes the deciding UE's slice.
:class:`TrunkDispatcher` does the same through the distilled flat trunk,
whose int8 form launches the ``flat_trunk`` kernel once a dispatch.

The baselines mirror ``rl.heuristics`` / ``rl.baselines`` in stream form:
full-local, interference-oblivious greedy over the clean-channel cost
table, nearest-server, and the occupancy-aware one-step oracle.

Policy forwards run under ``torch.inference_mode()`` (the ``flat_trunk``
kernel refuses inputs that require grad) on the env's device, and read
their action back in one host sync a dispatch. Sampled actions come from a
``torch.Generator`` on the env's device seeded with ``seed``, so they are
not the reference's draws; the deterministic modes decide what the
reference decides.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.env.mecenv import EnvState, MECEnv
from repro_torch.rl import nets
from repro_torch.rl.heuristics import _clean_cost_table


def stream_env_state(core) -> EnvState:
    """The stream's live state as the frame env's ``EnvState`` on the
    env's device: ``k`` counts each UE's queued and in-flight tasks,
    ``(l, n)`` is the in-service task's remaining UE-side work under its
    frozen rate, distances are the stream's. All UEs are active and
    ``gen`` is None: the policy forward draws nothing from it. One copy to
    the device."""
    n = core.env.params.n_ue
    host = np.empty((4, n), np.float32)
    for u in range(n):
        host[0, u] = len(core.queues[u]) + (core.serving[u] is not None)
        host[1, u], host[2, u] = core.in_flight_remainder(u)
    host[3] = core.d
    dev = core.env.device
    x = torch.as_tensor(host, device=dev)
    return EnvState(k=x[0], l=x[1], n=x[2], d=x[3],
                    t=torch.zeros((), dtype=torch.int32, device=dev), gen=None,
                    active=torch.ones((n,), dtype=torch.bool, device=dev), geom=None)


def _read_action(phys, ue):
    """The deciding UE's physical action as Python scalars, in one host
    sync: discrete heads as ints, continuous ones as floats (float32
    values, widened exactly)."""
    names = list(phys)
    vals = torch.stack([phys[k][ue].to(torch.float64) for k in names]).tolist()
    return {k: (v if phys[k].is_floating_point() else int(v)) for k, v in zip(names, vals)}


class _PolicyDispatcher:
    """The bridge both policy dispatchers share: snapshot -> masked
    distribution (``_dist``) -> mode or sample -> execute -> the deciding
    UE's slice, with the ``least_loaded_channel`` override when
    ``live_channel`` and the split offloads."""

    def __init__(self, env: MECEnv, *, deterministic, seed, live_channel):
        self.env = env
        self.deterministic = deterministic
        self.live_channel = live_channel
        self.b_local = env.n_actions_b - 1
        self.gen = torch.Generator(device=env.device).manual_seed(seed)
        self.masks = env.action_space.broadcast_masks(env.action_masks(), env.params.n_ue,
                                                      device=env.device)

    def _act(self, s):
        space = self.env.action_space
        with torch.inference_mode():
            dist = self._dist(s)
            raw = space.mode(dist, self.masks) if self.deterministic \
                else space.sample(self.gen, dist, self.masks)
            return raw, space.execute(raw)

    def _finish(self, core, ue, phys):
        act = _read_action(phys, ue)
        if self.live_channel and act["split"] < self.b_local:
            act["channel"] = least_loaded_channel(core, act.get("route", 0))
        return act


class EntityDispatcher(_PolicyDispatcher):
    """The frozen frame-trained entity policy as a live stream dispatcher.

    ``deterministic=False`` samples instead of taking the mode, the
    streaming deployment mode: the frame observation cannot carry live
    channel or server occupancy, so on occupancy-aliased states a tuned
    policy holds a load-spreading distribution and sampling realizes it.
    ``live_channel=True`` overrides the channel head with
    :func:`least_loaded_channel` on the chosen server. With ``record =
    True`` every decision's (EnvState snapshot, raw pre-squash actions,
    deciding UE) is kept in ``decisions``."""

    def __init__(self, env: MECEnv, agent, *, deterministic=True, seed=0, live_channel=False):
        if "entity_actor" not in agent:
            raise ValueError("EntityDispatcher needs an entity agent "
                             "({'entity_actor': ...}); train with "
                             "MAHPPOConfig(entity_policy=True)")
        super().__init__(env, deterministic=deterministic, seed=seed,
                         live_channel=live_channel)
        self.agent = agent
        self.record = False
        self.decisions = []          # (EnvState, raw actions dict, ue)

    def _dist(self, s):
        return nets.entity_actor_forward(self.agent["entity_actor"], self.env.action_space,
                                         self.env.observe_entities(s), self.masks)

    def __call__(self, core, ue):
        s = stream_env_state(core)
        raw, phys = self._act(s)
        if self.record:
            self.decisions.append((s, raw, ue))
        return self._finish(core, ue, phys)


class TrunkDispatcher(_PolicyDispatcher):
    """The distilled flat trunk (an f32 :class:`nets.MLP`, or its int8 form
    {"qlayers", "bits"} from ``rl.distill.quantize_flat_trunk``) as the
    live dispatcher: one trunk pass over ``observe_per_ue`` rows a
    dispatch, the int8 form through the ``flat_trunk`` kernel (one launch a
    dispatch on the card). Defaults are the deployment mode the teacher was
    streaming-tuned under: sampled actions and the ``least_loaded_channel``
    override."""

    def __init__(self, env: MECEnv, trunk, *, deterministic=False, seed=0, live_channel=True):
        if not (isinstance(trunk, nets.MLP) or (isinstance(trunk, dict) and "qlayers" in trunk)):
            raise ValueError("TrunkDispatcher needs flat-trunk params "
                             "(rl.distill.distill_entity_policy) or their "
                             "quantized form (quantize_flat_trunk)")
        super().__init__(env, deterministic=deterministic, seed=seed,
                         live_channel=live_channel)
        self.trunk = trunk

    def _dist(self, s):
        return nets.flat_trunk_forward(self.trunk, self.env.action_space,
                                       self.env.observe_per_ue(s), self.masks)

    def __call__(self, core, ue):
        return self._finish(core, ue, self._act(stream_env_state(core))[1])


def least_loaded_channel(core, server):
    """The channel of ``server`` with the fewest in-service transmitters
    right now (first minimum)."""
    counts = [0] * core.env.n_channels
    for u in range(core.env.params.n_ue):
        if core.tx[u] and int(core.route[u]) == server:
            counts[int(core.chan[u])] += 1
    return int(np.argmin(counts))


class LocalDispatcher:
    """Everything runs on the UE: the always-feasible full-local split, no
    transmission (power pinned at the head's floor)."""

    def __init__(self, env: MECEnv):
        self.b_local = env.n_actions_b - 1
        self.p_min = env.action_space.head("power").low

    def __call__(self, core, ue):
        return {"split": self.b_local, "channel": 0, "route": 0, "power": self.p_min}


class GreedyDispatcher:
    """Stream form of ``heuristics.greedy_eval``: each dispatch picks the
    UE's own argmin clean-channel (split[, server]) cell at max power,
    interference-oblivious, and the least-loaded channel on the chosen
    server at dispatch time."""

    def __init__(self, env: MECEnv, d=50.0):
        self.env = env
        self.cost = _clean_cost_table(env, d)   # (N, B+2[, E])
        self.p_max = float(env.params.p_max)

    def _pick(self, ue):
        if self.env.multi_server:
            flat = int(np.argmin(self.cost[ue].reshape(-1)))
            return flat // self.env.n_servers, flat % self.env.n_servers
        return int(np.argmin(self.cost[ue])), 0

    def __call__(self, core, ue):
        b, e = self._pick(ue)
        return {"split": b, "channel": least_loaded_channel(core, e), "route": e,
                "power": self.p_max}


class NearestServerDispatcher(GreedyDispatcher):
    """Stream form of ``baselines.nearest_server_eval``: every task goes to
    the closest server (least distance scale), at its best clean-channel
    split there."""

    def __init__(self, env: MECEnv, d=50.0):
        super().__init__(env, d)
        sd = env.params.server_dist.cpu().numpy() if env.multi_server else np.zeros((1,))
        self.nearest = int(np.argmin(sd))

    def _pick(self, ue):
        if not self.env.multi_server:
            return int(np.argmin(self.cost[ue])), 0
        return int(np.argmin(self.cost[ue, :, self.nearest])), self.nearest


class StreamOracleDispatcher:
    """Occupancy-aware one-step cost minimizer: the label source of
    ``rl.streaming.finetune_streaming`` and the strongest non-learned
    stream baseline.

    Per dispatch it sweeps every feasible offloading (split, channel,
    server) and a small power grid, computing each candidate's uplink rate
    under the live transmitting set (committing the candidate occupancy as
    ``core.start`` will) and its Eq. 7/8 service time under the live
    processor-sharing load, and keeps the first strict minimum of the
    service-time + energy cost (full-local is the first candidate). One
    ``rates`` call (one host sync) covers every split of a (server,
    channel, power) candidate."""

    def __init__(self, env: MECEnv, *, tail_weight=1.0, energy_weight=0.1,
                 powers=(0.5, 0.75, 0.98)):
        self.env = env
        self.t0 = float(env.params.t0)
        self.tail_weight = tail_weight
        self.energy_weight = energy_weight
        # float32 products, as the reference's f * p_max on its float32 p_max
        self.p_grid = [float(np.float32(f) * np.float32(env.params.p_max)) for f in powers]
        self.p_min = env.action_space.head("power").low
        self.feasible = env.params.feasible.cpu().numpy()
        self.b_local = env.n_actions_b - 1

    def _cost(self, t_svc, energy):
        return self.tail_weight * t_svc / self.t0 + self.energy_weight * energy

    def __call__(self, core, ue):
        env, phys = self.env, core.phys
        n_srv = env.n_servers if env.multi_server else 1
        offl_bs = [b for b in range(env.n_actions_b)
                   if self.feasible[ue, b] and core.n_new_of(ue, b) > 0]
        # full-local is always a candidate (no tx, no load, floor power)
        t_loc, e_loc = phys.service(ue, self.b_local, 1.0, self.p_min)
        best = (self._cost(t_loc, e_loc),
                {"split": self.b_local, "channel": 0, "route": 0, "power": self.p_min})
        saved = (bool(core.tx[ue]), int(core.chan[ue]), int(core.route[ue]),
                 float(core.power[ue]))
        core.tx[ue] = True
        for e in range(n_srv):
            core.route[ue] = e
            load = int(sum(1 for u in range(len(core.serving))
                           if core.tx[u] and int(core.route[u]) == e))
            for c in range(env.n_channels):
                core.chan[ue] = c
                for p in self.p_grid:
                    core.power[ue] = p
                    # the rate does not depend on the split
                    r = float(phys.rates(core.d, core.chan, core.power, core.route,
                                         core.tx)[ue])
                    for b in offl_bs:
                        t_svc, en = phys.service(ue, b, r, p, server_load=load, route=e)
                        cost = self._cost(t_svc, en)
                        if cost < best[0]:
                            best = (cost, {"split": b, "channel": c, "route": e, "power": p})
        core.tx[ue], core.chan[ue] = saved[0], saved[1]
        core.route[ue], core.power[ue] = saved[2], saved[3]
        return best[1]
