"""Event-heap continuous-time MEC stream simulator, the port of
``src/repro/stream/events.py``: the same physics as the frame env.

Where :class:`repro_torch.env.mecenv.MECEnv` advances one frame at a time
with every UE deciding together, this simulator advances an event heap in
continuous time: tasks arrive per UE as Poisson (or deterministic)
processes, each carries a per-class deadline, and a dispatcher is asked for
a decision ``{split, channel[, route], power}`` the moment a task reaches
the head of its UE's queue. Service is non-preemptive and its duration is
the Eq. 7/8 closed form (``core.overhead.task_latency_energy``), over
rates from the env's own ``_rates`` (interference, per-server path loss
and channels) and processor-shared edge seconds from the env's ``t_edge``
table.

A task's rate, edge load and service time are frozen at service start;
later starts and completions do not adjust in-flight durations (the
continuous-time analog of the frame env fixing a frame's rates at its
start). An in-service offloading task holds its (server, channel) slot and
counts toward its server's processor-sharing load for its whole service.

Deadlines are handled lazily: a queued task whose deadline has passed when
it reaches the head is dropped (never served); an in-service task runs to
completion, and a late finish is a miss but not a drop. The ledger

    arrivals == completed + dropped + queued + in_flight

holds after every event (``ledger()``).

Determinism: the heap is keyed ``(time, seq)`` with a monotone sequence
breaking ties, and every random draw comes from the per-UE
``numpy.random.default_rng([seed, ue])`` streams the reference draws from,
so the arrival processes are the reference's bit for bit. The state and
bookkeeping live in :class:`StreamCore`, so the heap loop here and the
virtual-time asyncio daemon (``dispatcher.py``) run the same start and
finish logic.

The physics run on the env's device: each ``rates`` call is one copy to
the device, the env's float32 ``_rates`` and one copy back (a host sync),
made once a service start and once an oracle candidate.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools

import numpy as np
import torch

from repro_torch.core.overhead import task_latency_energy
from repro_torch.env.mecenv import MECEnv
from repro_torch.stream.qos import QoSMonitor, TaskRecord


@dataclasses.dataclass(frozen=True)
class StreamParams:
    """One streaming scenario. ``rate`` is the per-UE mean arrival rate
    (tasks/s); arrivals stop at ``horizon`` and the sim drains the
    backlog. ``classes`` is the task-class mix as (weight, relative
    deadline seconds) pairs. ``deterministic`` replaces the Poisson gaps
    with a fixed ``1/rate`` spacing (per-UE phase offsets avoid
    synchronized arrivals). ``d_eval`` pins every UE at one distance like
    the env's eval mode; ``None`` draws distances uniformly from the env's
    [d_low, d_high)."""
    rate: float = 4.0
    horizon: float = 30.0
    classes: tuple = ((0.75, 1.0), (0.25, 0.4))
    deterministic: bool = False
    d_eval: float = 50.0


class StreamPhysics:
    """The MECEnv physics the stream needs: float64 numpy copies of the
    split tables and the env's own ``_rates`` on its device. Static pool
    geometry only. ``rate_calls`` counts the ``rates`` calls, each one
    host sync."""

    def __init__(self, env: MECEnv):
        self.env = env
        prm = env.params
        host = lambda t: t.detach().cpu().numpy().astype(np.float64)
        self.l_new = host(prm.l_new)
        self.n_new = host(prm.n_new)
        self.p_compute = host(prm.p_compute)
        self.t_edge = None if prm.t_edge is None else host(prm.t_edge)
        self.rate_calls = 0

    def rates(self, d, chan, power, route, tx):
        """(N,) float64 uplink rates under the current transmitting set:
        the env's float32 interference model, as the reference's jitted
        wrapper computes it."""
        self.rate_calls += 1
        env = self.env
        packed = np.stack([np.asarray(d, np.float32), np.asarray(chan, np.float32),
                           np.asarray(power, np.float32), np.asarray(route, np.float32),
                           np.asarray(tx, np.float32)])
        x = torch.as_tensor(packed, device=env.device)
        e = x[3].long() if env.multi_server else None
        r = env._rates(x[0], x[1].long(), x[2], e, x[4].bool())
        return r.cpu().numpy().astype(np.float64)

    def service(self, ue, b, rate, power, *, server_load=1, route=0):
        """Frozen-at-start service seconds and UE energy of one task: the
        Eq. 7/8 closed form, with the processor-shared edge tail
        ``t_edge[ue, b, route] * max(load, 1)`` as ``env._edge_seconds``
        charges it."""
        te = None
        if self.t_edge is not None:
            te = self.t_edge[ue, b, route] * max(server_load, 1)
        t, e = task_latency_energy(self.l_new[ue, b], self.n_new[ue, b],
                                   rate, self.p_compute[ue], power, te)
        return float(t), float(e)


class StreamCore:
    """Queues, occupancy and frozen-service bookkeeping: everything about
    the stream except what advances time (which sets ``now``).
    Dispatchers (``adapter.py``) read ``queues``, ``serving``, the
    ``tx``/``chan``/``route``/``power`` occupancy vectors, ``d``, ``now``
    and ``in_flight_remainder``."""

    def __init__(self, env: MECEnv, sp: StreamParams, seed: int = 0):
        self.env = env
        self.sp = sp
        self.phys = StreamPhysics(env)
        n = env.params.n_ue
        if sp.d_eval is not None:
            self.d = np.full((n,), float(sp.d_eval))
        else:
            self.d = np.random.default_rng([seed, n]).uniform(
                float(env.params.d_low), float(env.params.d_high), n)
        self.now = 0.0
        self.queues = [collections.deque() for _ in range(n)]
        self.serving = [None] * n            # in-service TaskRecord per UE
        self.tx = np.zeros((n,), bool)       # offloading in-service
        self.chan = np.zeros((n,), np.int32)
        self.route = np.zeros((n,), np.int32)
        self.power = np.full((n,), 1e-4)
        self.monitor = QoSMonitor()
        self.arrivals = 0
        self.completed = 0
        self.dropped = 0
        # per-UE streams: the heap sim and the daemon draw the same
        # arrival processes whatever order events interleave in
        self.rngs = [np.random.default_rng([seed, ue]) for ue in range(n)]
        self._tid = itertools.count()
        self._start_seq = itertools.count()
        w = np.asarray([c[0] for c in sp.classes], np.float64)
        self._cls_p = w / w.sum()
        self._cls_dl = np.asarray([c[1] for c in sp.classes], np.float64)

    # ------------------------------------------------------------ arrivals
    def first_arrival(self, ue):
        """Absolute time of ue's first arrival (deterministic mode phases
        the fleet across one period; Poisson draws an exponential gap)."""
        if self.sp.deterministic:
            n = self.env.params.n_ue
            return (ue + 1) / (n * self.sp.rate)
        return float(self.rngs[ue].exponential(1.0 / self.sp.rate))

    def next_gap(self, ue):
        if self.sp.deterministic:
            return 1.0 / self.sp.rate
        return float(self.rngs[ue].exponential(1.0 / self.sp.rate))

    def new_task(self, ue):
        """Draw a task arriving now for ue (class, absolute deadline) and
        admit it to the UE's queue."""
        cls = int(self.rngs[ue].choice(len(self._cls_p), p=self._cls_p))
        task = TaskRecord(tid=next(self._tid), ue=ue, cls=cls, t_arrive=self.now,
                          deadline=self.now + float(self._cls_dl[cls]))
        self.arrivals += 1
        self.queues[ue].append(task)
        return task

    # ------------------------------------------------------------- service
    def next_task(self, ue):
        """Head-of-queue task to serve next, after lazily dropping every
        queued task whose deadline already passed. None if the UE is busy
        or its queue is empty."""
        if self.serving[ue] is not None:
            return None
        q = self.queues[ue]
        while q:
            task = q.popleft()
            if self.now >= task.deadline:
                task.dropped = True
                task.t_done = self.now
                self.dropped += 1
                self.monitor.add(task)
                continue
            return task
        return None

    def start(self, task: TaskRecord, action) -> float:
        """Commit a dispatch decision: freeze occupancy, rate, edge load
        and the Eq. 7/8 service terms; returns the service seconds. The
        rate is computed with this task's own occupancy committed, so
        simultaneous offloaders interfere as in ``env.step``."""
        ue = task.ue
        b = int(action["split"])
        c = int(action["channel"])
        e = int(action.get("route", 0))
        p = float(action["power"])
        offl = self.n_new_of(ue, b) > 0
        self.serving[ue] = task
        self.chan[ue] = c
        self.route[ue] = e
        self.power[ue] = p
        self.tx[ue] = offl
        load = 1
        if self.env.multi_server:
            load = int(sum(1 for u in range(len(self.serving))
                           if self.tx[u] and int(self.route[u]) == e))
        r = float(self.phys.rates(self.d, self.chan, self.power, self.route, self.tx)[ue])
        t_svc, energy = self.phys.service(ue, b, r, p, server_load=load, route=e)
        task.t_start = self.now
        task.start_seq = next(self._start_seq)
        task.b, task.channel, task.server, task.power = b, c, e, p
        task.rate, task.t_service, task.energy = r, t_svc, energy
        return t_svc

    def finish(self, task: TaskRecord):
        """Service completion: release occupancy, record the task."""
        ue = task.ue
        task.t_done = self.now
        self.serving[ue] = None
        self.tx[ue] = False
        self.completed += 1
        self.monitor.add(task)

    def n_new_of(self, ue, b):
        return float(self.phys.n_new[ue, b])

    def in_flight_remainder(self, ue):
        """(local seconds, offload bits) left of ue's in-service task at
        ``now`` under its frozen rate: the frame state's carry-over (l, n).
        The edge tail is not represented, as in the frame state."""
        task = self.serving[ue]
        if task is None:
            return 0.0, 0.0
        el = self.now - task.t_start
        l_b = self.phys.l_new[ue, task.b]
        n_b = self.phys.n_new[ue, task.b]
        l_rem = max(l_b - el, 0.0)
        n_rem = max(n_b - max(el - l_b, 0.0) * task.rate, 0.0)
        return l_rem, n_rem

    # ------------------------------------------------------------- reports
    def ledger(self):
        """Task-conservation counts; ``arrivals == completed + dropped +
        queued + in_flight`` after every event."""
        return {"arrivals": self.arrivals, "completed": self.completed,
                "dropped": self.dropped,
                "queued": sum(len(q) for q in self.queues),
                "in_flight": sum(t is not None for t in self.serving)}

    def report(self):
        rep = self.monitor.report(horizon=self.sp.horizon)
        rep["arrivals"] = self.arrivals
        return rep


class StreamSim(StreamCore):
    """The event-heap loop: ``run()`` processes arrival and completion
    events in ``(time, seq)`` order until the stream has drained.
    ``dispatch`` is any callable ``(core, ue) -> action dict`` (see
    ``adapter.py``)."""

    def __init__(self, env: MECEnv, dispatch, sp: StreamParams = None, seed: int = 0):
        super().__init__(env, sp or StreamParams(), seed)
        self.dispatch = dispatch
        self._seq = itertools.count()
        self.heap = []
        for ue in range(env.params.n_ue):
            t0 = self.first_arrival(ue)
            if t0 < self.sp.horizon:
                self._push(t0, "arrive", ue)

    def _push(self, t, kind, payload):
        heapq.heappush(self.heap, (t, next(self._seq), kind, payload))

    def _try_start(self, ue):
        task = self.next_task(ue)
        if task is None:
            return
        t_svc = self.start(task, self.dispatch(self, ue))
        self._push(self.now + t_svc, "done", task)

    def step(self) -> bool:
        """Process one event; False once the heap is empty."""
        if not self.heap:
            return False
        t, _, kind, payload = heapq.heappop(self.heap)
        self.now = t
        if kind == "arrive":
            ue = payload
            self.new_task(ue)
            nxt = t + self.next_gap(ue)
            if nxt < self.sp.horizon:
                self._push(nxt, "arrive", ue)
            self._try_start(ue)
        else:                                        # "done"
            task = payload
            self.finish(task)
            self._try_start(task.ue)
        return True

    def run(self):
        while self.step():
            pass
        return self.report()
