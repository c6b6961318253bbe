"""Policy-as-dispatcher asyncio daemon over a deterministic virtual clock,
the port of ``src/repro/stream/dispatcher.py``.

In-process mock UE coroutines generate tasks and send them through
mailboxes to a dispatcher daemon; the daemon asks its policy (any
``adapter.py`` dispatcher) for a decision, commits it through the same
:class:`StreamCore` bookkeeping the event-heap simulator uses, and hands
the task to the routed server coroutine, which "executes" it for the
frozen Eq. 7/8 service duration and reports completion back.

Time is virtual: every ``sleep`` goes through :class:`VirtualClock`, a
``(time, seq)``-keyed timer heap advanced only when the coroutine world
has settled (no runnable coroutine, no undelivered message). Event order
is a pure function of (env, policy, params, seed). UE coroutines draw
their arrivals from the same per-UE ``default_rng([seed, ue])`` streams as
:class:`~repro_torch.stream.events.StreamSim`, so a dispatcher that reads
no more than the state both runtimes share gives the heap simulator's
records exactly. The daemon is device-free apart from the policy it
calls.
"""
from __future__ import annotations

import asyncio
import collections
import heapq
import itertools

from repro_torch.env.mecenv import MECEnv
from repro_torch.stream.events import StreamCore, StreamParams


class VirtualClock:
    """Deterministic discrete-event time for asyncio: ``sleep(dt)``
    parks the caller on a ``(now + dt, seq)`` heap entry and ``run()``
    advances to the earliest timer only once every coroutine has gone
    idle. ``_activity`` counts state changes (timer pushes, mailbox
    puts); the settle loop yields until it stops moving, which bounds
    the event-loop passes deterministically (no wall-clock waits)."""

    def __init__(self):
        self.now = 0.0
        self._timers = []
        self._seq = itertools.count()
        self._activity = 0

    def sleep(self, dt):
        fut = asyncio.get_running_loop().create_future()
        heapq.heappush(self._timers, (self.now + dt, next(self._seq), fut))
        self._activity += 1
        return fut

    async def _settle(self):
        idle, last = 0, -1
        while idle < 3:
            if self._activity == last:
                idle += 1
            else:
                idle, last = 0, self._activity
            await asyncio.sleep(0)

    async def run(self):
        """Advance until no timers remain: pop one timer, move ``now``,
        wake its sleeper, let the world settle, repeat."""
        await self._settle()
        while self._timers:
            t, _, fut = heapq.heappop(self._timers)
            self.now = t
            if not fut.cancelled():
                fut.set_result(None)
            await self._settle()


class Mailbox:
    """A deterministic in-process message queue: ``put`` never blocks and
    bumps the clock's activity counter so the settle loop knows a message
    is still undelivered."""

    def __init__(self, clock: VirtualClock):
        self._q = collections.deque()
        self._clock = clock
        self._waiter = None

    def put(self, msg):
        self._q.append(msg)
        self._clock._activity += 1
        if self._waiter is not None and not self._waiter.done():
            self._waiter.set_result(None)

    async def get(self):
        while not self._q:
            self._waiter = asyncio.get_running_loop().create_future()
            await self._waiter
        return self._q.popleft()


async def _ue_process(core: StreamCore, clock: VirtualClock,
                      to_daemon: Mailbox, ue: int):
    """Mock UE: sleeps out its (seeded, per-UE-stream) arrival gaps and
    mails each new task to the dispatcher. Draw order per UE matches
    StreamSim's arrival handling exactly, so the processes coincide."""
    t_next = core.first_arrival(ue)
    while t_next < core.sp.horizon:
        await clock.sleep(t_next - clock.now)
        core.now = clock.now
        task = core.new_task(ue)
        to_daemon.put(("task", task))
        t_next = clock.now + core.next_gap(ue)


async def _server_process(clock: VirtualClock, inbox: Mailbox,
                          to_daemon: Mailbox, log=None):
    """Mock edge server: "executes" each assigned task for its frozen
    service duration, then reports completion. The physics (including
    this server's processor-sharing load) were already committed by the
    daemon's ``core.start``; the worker's job is to own the passage of
    service time. Each task runs in its OWN sub-coroutine — tasks from
    different UEs genuinely execute concurrently on one server (that is
    the processor-sharing model), they must not serialize through the
    mailbox."""
    async def execute(task, t_svc):
        await clock.sleep(t_svc)
        if log is not None:
            log.append((task.tid, task.server, clock.now))
        to_daemon.put(("done", task))

    running = []
    while True:
        kind, task, t_svc = await inbox.get()
        if kind == "stop":
            await asyncio.gather(*running)   # all done once the clock dried
            return
        running.append(asyncio.ensure_future(execute(task, t_svc)))


async def _daemon(core: StreamCore, clock: VirtualClock, policy,
                  inbox: Mailbox, servers):
    """The dispatcher daemon: admits arriving tasks, asks the policy for
    a decision whenever a UE goes idle with queued work, and routes the
    committed task to its server's mailbox. Lazy deadline drops happen
    in ``core.next_task`` exactly as in the heap simulator. Runs forever
    — ``run_daemon`` cancels it once the virtual clock runs dry, at
    which point every task has completed or been dropped (enforced by
    the ledger check)."""
    while True:
        kind, task = await inbox.get()
        core.now = clock.now
        if kind == "done":
            core.finish(task)
        ue = task.ue
        nxt = core.next_task(ue)
        if nxt is not None:
            t_svc = core.start(nxt, policy(core, ue))
            servers[nxt.server].put(("serve", nxt, t_svc))


def run_daemon(env: MECEnv, policy, sp: StreamParams = None, *, seed=0,
               server_log=None):
    """Run one streaming episode through the asyncio daemon; returns
    (QoS report dict, StreamCore). Deterministic in ``seed``: virtual
    time only, per-UE arrival streams, (time, seq) tie-breaks."""
    sp = sp or StreamParams()
    core = StreamCore(env, sp, seed)

    async def main():
        clock = VirtualClock()
        to_daemon = Mailbox(clock)
        n_srv = env.n_servers
        server_in = [Mailbox(clock) for _ in range(n_srv)]
        for ue in range(env.params.n_ue):
            asyncio.ensure_future(_ue_process(core, clock, to_daemon, ue))
        servers = [asyncio.ensure_future(
            _server_process(clock, server_in[e], to_daemon, server_log))
            for e in range(n_srv)]
        daemon = asyncio.ensure_future(
            _daemon(core, clock, policy, to_daemon, server_in))
        await clock.run()
        for e in range(n_srv):
            server_in[e].put(("stop", None, 0.0))
        await asyncio.gather(*servers)
        daemon.cancel()
        await asyncio.gather(daemon, return_exceptions=True)

    asyncio.run(main())
    led = core.ledger()
    if led["queued"] or led["in_flight"] or \
            led["arrivals"] != led["completed"] + led["dropped"]:
        raise RuntimeError(f"daemon ended with an unbalanced ledger: {led}")
    return core.report(), core
