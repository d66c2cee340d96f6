"""Fault tolerance and elasticity policies (``repro.runtime.fault``).

Three mechanisms, copies of the JAX package's:

* FailureDetector — wraps step execution; classifies exceptions and
  decides restart-from-checkpoint vs re-raise. Repeated failures within a
  window trigger an elastic downsize instead of hot-looping restarts.
* StragglerMonitor — tracks per-step durations; a step exceeding
  ``multiplier``x the trailing median marks a straggler event. The loop
  responds per policy: log, re-dispatch the step (recompute — steps are
  deterministic functions of (seed, step)), or after repeated events,
  request a re-mesh that drops the slow host.
* plan_elastic_remesh — given a new device inventory, pick the largest
  (data, model) grid that divides the batch, so a 512-device job
  restarts on e.g. 448 healthy devices. The port trains on one card: the
  plan is policy only until the mesh scaffolding is ported.

A failure is exercised by injection (``runtime.train_loop.Trainer``'s
``fail_injector``): the recovery (checkpoint restore, deterministic data
replay) is the code that would run on a real failure.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple


class WorkerFailure(RuntimeError):
    """A (possibly injected) worker/device failure."""


@dataclasses.dataclass
class RestartDecision:
    action: str                  # "restart" | "remesh" | "raise"
    restore_step: Optional[int] = None
    reason: str = ""


class FailureDetector:
    def __init__(self, max_restarts: int = 3, window_s: float = 3600.0):
        self.max_restarts = max_restarts
        self.window_s = window_s
        self.events: deque = deque()

    def on_failure(self, exc: Exception, latest_ckpt: Optional[int]
                   ) -> RestartDecision:
        # monotonic: the restart window is pure interval math and must
        # not widen/collapse when NTP steps the wall clock. (Metrics
        # timestamps elsewhere stay wall-clock.)
        now = time.monotonic()
        while self.events and now - self.events[0] > self.window_s:
            self.events.popleft()
        if not isinstance(exc, (WorkerFailure, OSError)):
            return RestartDecision("raise", reason=f"non-retryable: {exc}")
        if latest_ckpt is None:
            return RestartDecision("raise",
                                   reason="no checkpoint to restart from")
        self.events.append(now)  # count only retryable, restartable events
        if len(self.events) > self.max_restarts:
            return RestartDecision("remesh", restore_step=latest_ckpt,
                                   reason=f"{len(self.events)} failures in "
                                          f"window: downsizing")
        return RestartDecision("restart", restore_step=latest_ckpt,
                               reason=str(exc))


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    median_s: float


class StragglerMonitor:
    """Deadline = multiplier x trailing-median step time."""

    def __init__(self, multiplier: float = 3.0, history: int = 32,
                 warmup_steps: int = 3):
        self.multiplier = multiplier
        self.durations: deque = deque(maxlen=history)
        self.warmup_steps = warmup_steps
        self.events: List[StragglerEvent] = []

    def deadline(self) -> Optional[float]:
        if len(self.durations) < self.warmup_steps:
            return None
        med = sorted(self.durations)[len(self.durations) // 2]
        return med * self.multiplier

    def observe(self, step: int, duration_s: float) -> Optional[StragglerEvent]:
        dl = self.deadline()
        self.durations.append(duration_s)
        if dl is not None and duration_s > dl:
            ev = StragglerEvent(step, duration_s,
                                dl / self.multiplier)
            self.events.append(ev)
            return ev
        return None


def plan_elastic_remesh(num_devices: int, global_batch: int,
                        model_axis_candidates: Sequence[int] = (16, 8, 4, 2, 1),
                        orig_model: int = 16) -> Tuple[int, int]:
    """Largest (data, model) grid over surviving devices such that
    data*model <= num_devices and data divides global_batch. Ties keep
    the original TP degree when possible (cheapest re-shard), otherwise
    prefer data parallelism."""
    options = []
    for model in model_axis_candidates:
        if num_devices % model:
            continue
        data = num_devices // model
        while data > 1 and global_batch % data:
            data -= 1
        options.append((data, model))
    if not options:
        return (1, 1)
    best_product = max(d * m for d, m in options)
    tied = [(d, m) for d, m in options if d * m == best_product]
    for d, m in tied:
        if m == orig_model:
            return (d, m)
    return max(tied, key=lambda dm: dm[0])
