"""Fault tolerance and straggler detection.

The counterpart of `src/repro/runtime/ft.py`:

* :class:`StepMonitor` — per-step wall-time EWMA; flags straggling steps and
  calls a hook.
* :class:`TrainSupervisor` — checkpoint/restart driver: periodic
  asynchronous checkpoints, failure injection for tests, resume from the
  latest manifest.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint.store import CheckpointStore


@dataclass
class StepMonitor:
    ewma_alpha: float = 0.2
    straggler_factor: float = 2.0
    warmup: int = 3
    ewma: float = 0.0
    steps: int = 0
    stragglers: List[int] = field(default_factory=list)
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def record(self, step: int, duration_s: float) -> bool:
        self.steps += 1
        if self.steps <= self.warmup:
            self.ewma = duration_s if self.ewma == 0.0 else (
                0.5 * (self.ewma + duration_s))
            return False
        is_straggler = duration_s > self.straggler_factor * self.ewma
        if is_straggler:
            self.stragglers.append(step)
            if self.on_straggler:
                self.on_straggler(step, duration_s, self.ewma)
        else:
            self.ewma = (1 - self.ewma_alpha) * self.ewma \
                + self.ewma_alpha * duration_s
        return is_straggler


class SimulatedFailure(RuntimeError):
    pass


class TrainSupervisor:
    """Runs `step_fn` with periodic checkpoints; survives injected failures
    by restoring the latest checkpoint and continuing. As in the reference,
    a failure before the first checkpoint restarts at step 0 with the
    *current* params and optimizer state (not the initial ones)."""

    def __init__(self, store: CheckpointStore, checkpoint_every: int = 50,
                 monitor: Optional[StepMonitor] = None):
        self.store = store
        self.every = checkpoint_every
        self.monitor = monitor or StepMonitor()
        self.restarts = 0

    def run(self, state: Dict[str, Any], step_fn: Callable,
            batch_fn: Callable, total_steps: int,
            fail_at: Optional[int] = None,
            on_step: Optional[Callable[[int, float, Dict[str, Any]], None]]
            = None) -> Dict[str, Any]:
        """state: {"params", "opt_state", "step"}; step_fn(params, opt_state,
        batch) -> (params, opt_state, metrics); batch_fn(step) -> batch.
        `fail_at` injects a failure once at that step (tests). A step's
        time on the monitor is what `step_fn` takes to return: a step_fn
        that ends in a device synchronise is timed whole. `on_step(step,
        seconds, metrics)` is called after each step with the monitor's
        time."""
        failed_once = False
        while state["step"] < total_steps:
            step = state["step"]
            try:
                if fail_at is not None and step == fail_at and not failed_once:
                    failed_once = True
                    raise SimulatedFailure(f"injected at step {step}")
                t0 = time.monotonic()
                params, opt_state, metrics = step_fn(
                    state["params"], state["opt_state"], batch_fn(step))
                duration = time.monotonic() - t0
                self.monitor.record(step, duration)
                if on_step is not None:
                    on_step(step, duration, metrics)
                state = {"params": params, "opt_state": opt_state,
                         "step": step + 1, "metrics": metrics}
                if (step + 1) % self.every == 0:
                    self.store.save(step + 1,
                                    {"params": state["params"],
                                     "opt_state": state["opt_state"]},
                                    extra={"step": step + 1})
            except SimulatedFailure:
                self.restarts += 1
                latest = self.store.latest_step()
                if latest is None:
                    state = {**state, "step": 0}
                    continue
                like = {"params": state["params"],
                        "opt_state": state["opt_state"]}
                restored, extra = self.store.restore(latest, like)
                state = {"params": restored["params"],
                         "opt_state": restored["opt_state"],
                         "step": extra["step"]}
        self.store.wait()
        return state
