"""Rack-scale arbitration: N per-core scheduler stacks, one far memory.

A rack run instantiates N complete engine+SPM+scheduler stacks (one per
core, each driving its own workload port with a private request-ID space)
over ONE shared :class:`~repro_torch.core.farmem.FarMemoryModel`, so the far
model's per-link serialization points, backpressure heaps and fault
streams become genuine cross-core contention. The
:class:`RackArbiter` here is the determinism keystone:

* **Global-clock order.** Every scheduler turn is a
  :meth:`~repro_torch.core.coroutines.Scheduler.step` call, and the arbiter
  always steps the live core with the **smallest core clock** (`sched.t`),
  breaking ties by **core index** (lowest first). A core's clock never
  decreases, so the shared far model sees the N command streams merged in
  a near-sorted order that is a pure function of (config, seed) — link
  free-time evolution, latency/fault RNG draws and ledger accumulation
  order are all reproducible bit-for-bit across runs.
* **cores=1 identity.** With one core the policy degenerates to
  `while live: step()`, which is literally the body of
  ``Scheduler.run`` — a single-core rack run is bit-identical (trace,
  stats, RNG bitstreams, summary) to today's ``AmuSession``.
* **Attribution.** The far model's request/byte/fault counters are
  global; the arbiter brackets each step with counter snapshots and a
  ``far.client`` tag, attributing every delta (and every serialized
  channel cycle, via ``FarMemoryModel.link_busy``) to the core that
  issued it. Attribution is pure accounting — it never feeds timing.

`repro_torch.amu.RackSession` owns the config/registry side (per-core workload
builds with independently spawned seeds, per-core `RunStats`,
`RackStats` aggregation); this module is deliberately free of any
workload or config knowledge.
"""
from __future__ import annotations

import time
from typing import List, Sequence

from repro_torch.core.coroutines import Scheduler
from repro_torch.core.farmem import FarMemoryModel


class RackArbiter:
    """Deterministic time-sliced interleaver over per-core schedulers.

    The schedulers must all share ``far`` as their engines' far-memory
    model (a single-element list is fine — that is the ``cores=1``
    identity path). Call :meth:`run` after spawning each core's tasks on
    its own scheduler.
    """

    def __init__(self, far: FarMemoryModel,
                 schedulers: Sequence[Scheduler]) -> None:
        if not schedulers:
            raise ValueError("RackArbiter needs at least one scheduler")
        self.far = far
        self.schedulers: List[Scheduler] = list(schedulers)
        n = len(self.schedulers)
        # per-core attribution of the shared far model's global counters
        self.requests = [0] * n
        self.bytes_moved = [0] * n
        self.errors = [0] * n
        self.timeouts = [0] * n
        self.steps = [0] * n
        self.wall_us = [0.0] * n

    @property
    def makespan(self) -> float:
        """Rack completion time: the slowest core's clock, cycles."""
        return max(s.t for s in self.schedulers)

    def run(self) -> None:
        """Interleave scheduler turns in (clock, core-index) order until
        every core's tasks have finished."""
        far = self.far
        scheds = self.schedulers
        live = [i for i, s in enumerate(scheds) if s.live > 0]
        while live:
            best = live[0]
            bt = scheds[best].t
            for i in live[1:]:         # strict < keeps the lowest index
                if scheds[i].t < bt:   # on clock ties (the arbiter rule)
                    best, bt = i, scheds[i].t
            s = scheds[best]
            far.client = best
            r0, b0 = far.requests, far.bytes_moved
            e0, t0 = far.errors, far.timeouts
            w0 = time.perf_counter()
            s.step()
            self.wall_us[best] += (time.perf_counter() - w0) * 1e6
            self.steps[best] += 1
            self.requests[best] += far.requests - r0
            self.bytes_moved[best] += far.bytes_moved - b0
            self.errors[best] += far.errors - e0
            self.timeouts[best] += far.timeouts - t0
            if s.live <= 0:
                live.remove(best)
        far.client = 0
