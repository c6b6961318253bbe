"""Streaming QoS, the port's copy of ``src/repro/stream/qos.py`` (numpy
only): per-task records, tail statistics and the SLO reward.

The frame env's Eq. 12 reward scores the mean overhead a frame; a serving
system is judged on the distribution: throughput, deadline-miss rate and
the p95 / p99 sojourn. The stream simulator (``events.py``) and the
asyncio daemon (``dispatcher.py``) both feed :class:`QoSMonitor`, and the
streaming fine-tune (``rl.streaming``) scores its episodes with
:func:`stream_reward`.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def tail_stats(samples, percentiles=(50, 95, 99)):
    """``{"p50": ..., "p95": ..., "p99": ...}`` over a 1-D sample array
    (numpy linear-interpolated percentiles). Empty input yields NaNs so a
    report of a fully-dropped stream stays well-formed instead of
    raising."""
    arr = np.asarray(list(samples), np.float64)
    if arr.size == 0:
        return {f"p{q:g}": float("nan") for q in percentiles}
    vals = np.percentile(arr, percentiles)
    return {f"p{q:g}": float(v) for q, v in zip(percentiles, vals)}


@dataclasses.dataclass
class TaskRecord:
    """One streamed task, from arrival to completion (or drop). The
    dispatch decision and its frozen-at-start physics (rate, service
    time) ride along so reports can be sliced by split/server/class."""
    tid: int
    ue: int
    cls: int
    t_arrive: float
    deadline: float             # ABSOLUTE deadline (arrival + class SLO)
    t_start: float = -1.0
    t_done: float = -1.0
    dropped: bool = False
    energy: float = 0.0
    # frozen dispatch decision (set at service start; -1 = never served)
    b: int = -1
    channel: int = -1
    server: int = 0
    power: float = 0.0
    rate: float = 0.0
    t_service: float = 0.0
    # order of this task among the core's start() calls (-1 = never
    # served): pairs each dispatch decision with the outcome of exactly
    # the task it dispatched, which is what rl.streaming reinforces
    start_seq: int = -1

    def task_cost(self, cfg, t0=0.5):
        """Per-task QoS cost (lower is better) of the DISPATCH DECISION:
        service seconds in frame-length units + the miss penalty + the
        energy term. Deliberately the service time, not the sojourn — the
        queue wait is fixed before the decision is made, so charging it
        would only add variance to the credit (the miss outcome still
        folds the deadline pressure in)."""
        return (cfg.tail_weight * self.t_service / t0
                + cfg.miss_penalty * float(self.missed)
                + cfg.energy_weight * self.energy)

    @property
    def sojourn(self) -> float:
        """Arrival-to-completion seconds (queueing + service)."""
        return self.t_done - self.t_arrive

    @property
    def missed(self) -> bool:
        """Dropped, or completed past its deadline (non-preemptive
        service runs to completion; a late finish still missed its SLO)."""
        return self.dropped or self.t_done > self.deadline


class QoSMonitor:
    """Accumulates finished :class:`TaskRecord`\\ s into a QoS report —
    the stream analog of the frame env's eval dict."""

    def __init__(self):
        self.records = []

    def add(self, rec: TaskRecord):
        self.records.append(rec)

    def report(self, horizon=None):
        recs = self.records
        done = [r for r in recs if not r.dropped]
        n = max(len(recs), 1)
        soj = [r.sojourn for r in done]
        rep = {
            "tasks": len(recs),
            "completed": len(done),
            "dropped": len(recs) - len(done),
            "drop_rate": (len(recs) - len(done)) / n,
            "miss_rate": sum(1 for r in recs if r.missed) / n,
            "sojourn_mean": float(np.mean(soj)) if done else float("nan"),
            "energy_task": float(np.mean([r.energy for r in done]))
            if done else float("nan"),
        }
        rep.update({f"sojourn_{k}": v for k, v in tail_stats(soj).items()})
        if horizon:
            rep["throughput"] = len(done) / horizon
        return rep


@dataclasses.dataclass(frozen=True)
class StreamRewardConfig:
    """Weights of the episode-level streaming reward: miss rate is the
    primary SLO term, the p99 sojourn (in units of the frame length t0)
    penalizes the tail even while misses are rare, and a small energy
    term keeps the paper's latency/energy trade-off alive."""
    miss_penalty: float = 4.0
    tail_weight: float = 1.0
    energy_weight: float = 0.1


def stream_reward(report, cfg: StreamRewardConfig = StreamRewardConfig(),
                  *, t0=0.5):
    """Scalar episode reward from a :meth:`QoSMonitor.report` dict —
    what ``rl.streaming`` fine-tunes against. Higher is better; a fully
    dropped stream (NaN tails) scores only its miss penalty."""
    r = -cfg.miss_penalty * report["miss_rate"]
    p99 = report.get("sojourn_p99", float("nan"))
    if p99 == p99:                                   # not NaN
        r -= cfg.tail_weight * p99 / t0
    e = report.get("energy_task", float("nan"))
    if e == e:
        r -= cfg.energy_weight * e
    return float(r)
