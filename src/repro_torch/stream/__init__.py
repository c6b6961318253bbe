"""Event-driven streaming serve runtime, the port of ``src/repro/stream``.

The frame MDP (``env.mecenv``) decides once a UE a frame and scores the
mean overhead; edge serving is a stream of asynchronous arrivals with
per-task deadlines, judged on miss rate and p99 sojourn. This package is
its continuous-time counterpart on the same physics (the env's ``_rates``,
the Eq. 7/8 closed form, processor-shared edge service):

* :mod:`repro_torch.stream.events`: the event-heap simulator;
* :mod:`repro_torch.stream.qos`: task records, tail statistics and the
  deadline + tail reward the streaming fine-tune (``rl.streaming``)
  optimizes;
* :mod:`repro_torch.stream.adapter`: the stream state as an ``EnvState``,
  so a frame-trained entity policy (or the distilled trunk) dispatches,
  and the greedy / nearest-server / full-local / oracle baselines;
* :mod:`repro_torch.stream.dispatcher`: the virtual-time asyncio daemon.
"""
from repro_torch.stream.events import StreamParams, StreamSim  # noqa: F401
from repro_torch.stream.qos import (QoSMonitor, StreamRewardConfig,  # noqa: F401
                                    TaskRecord, stream_reward, tail_stats)
