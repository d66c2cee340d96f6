"""Resilient oracle plane: fault injection + retry/breaker policy
(a numpy copy of ``repro.serve.resilience``).

The oracle LLM is the one *remote* dependency in the whole cascade
(~50 TFLOPs/doc, paper §6.2) and therefore the one that fails in
production: timeouts, rate-limit storms, poison documents that crash
the judge, whole-provider blackouts.

* ``ChaosOracle`` — a seeded fault injector wrapped around any raw
  oracle. Per-invocation drop probability, deadline timeouts, latency
  spikes, poison doc ids and scheduled blackout windows, all derived
  deterministically from ``(seed, invocation_index)`` so every replay
  sees the same fault schedule regardless of thread timing. Faults are
  raised *before* the inner oracle runs: a failed invocation never
  purchases labels, so retries can never double-pay.

* ``ResilientOracle`` — the policy layer. Wraps a ``CachedOracle``
  (or wraps a raw oracle in one) and presents the same surface
  (``acts_as_cached = True``), so the engine treats it as *the* shared
  label cache while every purchase is protected by:

    - capped exponential backoff with decorrelated jitter (seeded),
    - a per-invocation-tree deadline,
    - bisect-on-failure batch splitting — one poison document costs
      O(log B) extra invocations instead of failing the micro-batch,
    - a circuit breaker (closed → open → half-open with a single probe
      purchase) so a dead lane fails fast instead of queueing retries.

The schedules, jitter draws and counters are the JAX package's, so the
same ``ChaosConfig`` and seed give the same invocations, retries and
delays in both packages. Retries, bisections and breaker rejections
land on the calling session's current span as ``oracle.retry``,
``oracle.bisect`` and ``oracle.breaker_reject`` events (no-ops outside a
trace).

Exception taxonomy lives in ``repro_torch.core.oracle`` (``OracleError``
/ ``OracleFault`` / ``OracleTimeout`` / ``OracleUnavailable``) so the
engine can catch it without importing this package.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.oracle import (CachedOracle, OracleError,
                                     OracleFault, OracleTimeout,
                                     OracleUnavailable)
from repro_torch.runtime import trace as trace_mod

__all__ = [
    "ChaosConfig", "ChaosOracle", "RetryPolicy", "BreakerConfig",
    "CircuitBreaker", "ResilientOracle", "decorrelated_jitter",
    "OracleError", "OracleFault", "OracleTimeout", "OracleUnavailable",
]


# --------------------------------------------------------------------------
# fault injection
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Seeded fault schedule. All randomness is keyed on
    ``(seed, invocation_index)`` — not on a shared stream — so the fault
    a given invocation sees is independent of thread interleaving."""

    seed: int = 0
    fail_rate: float = 0.0          # P(drop) per invocation
    timeout_rate: float = 0.0       # P(deadline timeout) per invocation
    spike_rate: float = 0.0         # P(latency spike) per invocation
    spike_seconds: float = 0.0      # injected latency when spiking
    poison_docs: Tuple[int, ...] = ()   # doc ids that always fault
    blackouts: Tuple[Tuple[int, int], ...] = ()  # [start, end) invocation windows


class ChaosOracle:
    """Deterministic fault-injection wrapper around a raw oracle.

    Raises *before* touching ``inner`` — a faulted invocation buys
    nothing, which is what makes the no-double-purchase invariant hold
    across retries. ``heal()`` switches all injection off (the
    "provider recovered" event in tests and benchmarks)."""

    def __init__(self, inner, chaos: ChaosConfig = ChaosConfig(), *,
                 sleep: Callable[[float], None] = time.sleep):
        self.inner = inner
        self.chaos = chaos
        self._sleep = sleep
        self._lock = threading.Lock()
        self._poison = frozenset(int(d) for d in chaos.poison_docs)
        self.healed = False
        self.invocations = 0
        self.faults = {"drop": 0, "timeout": 0, "blackout": 0,
                       "poison": 0, "spike": 0}

    # -- passthrough accounting (the raw oracle's counters stay truthful)
    @property
    def calls(self):
        return self.inner.calls

    @property
    def queried(self):
        return getattr(self.inner, "queried", set())

    @property
    def flops_per_doc(self):
        return getattr(self.inner, "flops_per_doc", None)

    def heal(self) -> None:
        """Stop injecting faults (scheduled blackouts included)."""
        self.healed = True

    def label(self, indices: Sequence[int]) -> np.ndarray:
        indices = np.asarray(indices, dtype=np.int64)
        with self._lock:
            k = self.invocations
            self.invocations += 1
        if not self.healed:
            self._maybe_fault(k, indices)
        return self.inner.label(indices)

    def _maybe_fault(self, k: int, indices: np.ndarray) -> None:
        c = self.chaos
        for start, end in c.blackouts:
            if start <= k < end:
                with self._lock:
                    self.faults["blackout"] += 1
                raise OracleFault(
                    f"chaos: blackout window [{start},{end}) at invocation {k}")
        u_timeout, u_fail, u_spike = \
            np.random.default_rng([c.seed, k]).random(3)
        if u_timeout < c.timeout_rate:
            with self._lock:
                self.faults["timeout"] += 1
            raise OracleTimeout(f"chaos: deadline timeout at invocation {k}")
        if u_fail < c.fail_rate:
            with self._lock:
                self.faults["drop"] += 1
            raise OracleFault(f"chaos: dropped invocation {k}")
        if self._poison:
            hit = sorted(self._poison.intersection(int(i) for i in indices))
            if hit:
                with self._lock:
                    self.faults["poison"] += 1
                raise OracleFault(f"chaos: poison docs {hit} at invocation {k}")
        if u_spike < c.spike_rate and c.spike_seconds > 0:
            with self._lock:
                self.faults["spike"] += 1
            self._sleep(c.spike_seconds)


# --------------------------------------------------------------------------
# retry policy
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3           # attempts at the top of an ask
    base_delay_s: float = 0.001     # first backoff delay
    max_delay_s: float = 0.050      # backoff cap
    deadline_s: float = 5.0         # budget for one ask incl. retries
    call_timeout_s: float = 0.0     # soft per-call deadline (0 = off)
    bisect: bool = True             # split failing batches


def decorrelated_jitter(rng: np.random.Generator, prev: float,
                        base: float, cap: float) -> float:
    """AWS-style decorrelated jitter: ``min(cap, U(base, prev*3))``.
    Always within ``[base, cap]`` for ``cap >= base``."""
    hi = max(base, prev * 3.0)
    return min(float(cap), float(rng.uniform(base, hi)))


# --------------------------------------------------------------------------
# circuit breaker
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    failure_threshold: int = 3      # consecutive dead asks to open
    cooldown_s: float = 1.0         # open -> half-open delay
    probe_retry_after_s: float = 0.05   # advisory wait while probing


class CircuitBreaker:
    """closed → open → half-open with a single probe purchase.

    * closed: everything flows; ``failure_threshold`` *consecutive*
      zero-success asks open it.
    * open: every ask is rejected instantly with a retry-after horizon
      until ``cooldown_s`` has elapsed.
    * half-open: exactly one probe ask is admitted; success closes the
      breaker, failure re-opens it (fresh cooldown). Other asks are
      rejected while the probe is in flight.

    ``clock`` is injectable (monotonic by default) so tests and property
    checks drive time explicitly. ``on_half_open`` fires (outside the
    lock) on the open→half-open transition — a caller can re-drain the
    engine's deferred-repair queue the moment the lane may be back.
    """

    def __init__(self, cfg: BreakerConfig = BreakerConfig(), *,
                 clock: Callable[[], float] = time.monotonic,
                 on_half_open: Optional[Callable[[], None]] = None):
        self.cfg = cfg
        self._clock = clock
        self._on_half_open = on_half_open
        self._lock = threading.Lock()
        self.state = "closed"
        self.failures = 0           # consecutive zero-success asks
        self.opened_at = 0.0
        self._probing = False
        self.opens = 0              # lifetime closed/half-open -> open

    def allow(self) -> Tuple[bool, float]:
        """(admitted, retry_after). Fires ``on_half_open`` when the
        cooldown elapses."""
        fire = False
        with self._lock:
            if self.state == "closed":
                out = (True, 0.0)
            elif self.state == "open":
                waited = self._clock() - self.opened_at
                if waited >= self.cfg.cooldown_s:
                    self.state = "half_open"
                    self._probing = True
                    fire = True
                    out = (True, 0.0)
                else:
                    out = (False, self.cfg.cooldown_s - waited)
            else:  # half_open
                if self._probing:
                    out = (False, self.cfg.probe_retry_after_s)
                else:
                    self._probing = True
                    out = (True, 0.0)
        if fire and self._on_half_open is not None:
            self._on_half_open()
        return out

    def record_success(self) -> None:
        with self._lock:
            self.state = "closed"
            self.failures = 0
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._probing = False
            if self.state == "half_open":
                self.state = "open"
                self.opened_at = self._clock()
                self.opens += 1
                return
            self.failures += 1
            if (self.state == "closed"
                    and self.failures >= self.cfg.failure_threshold):
                self.state = "open"
                self.opened_at = self._clock()
                self.opens += 1

    def retry_after(self) -> float:
        with self._lock:
            if self.state != "open":
                return 0.0
            return max(0.0, self.cfg.cooldown_s
                       - (self._clock() - self.opened_at))

    def status(self) -> dict:
        with self._lock:
            return {"state": self.state, "failures": self.failures,
                    "opens": self.opens}


# --------------------------------------------------------------------------
# the policy layer
# --------------------------------------------------------------------------

class ResilientOracle:
    """Retry/breaker/bisect policy over a shared label cache.

    Presents the full ``CachedOracle`` surface (``acts_as_cached``), so
    ``ScaleDocEngine._cached_oracle`` adopts it as the per-oracle cache
    and no other layer needs resilience configuration. With a healthy
    oracle it is bit-transparent — same labels, same purchase counts,
    zero extra invocations.

    Purchase flow for an ask with cache misses::

        breaker.allow() ─no─> OracleUnavailable(breaker_open=True)
          │yes
        retry loop (decorrelated-jitter backoff, deadline budget)
          │exhausted
        bisect halves (poison isolation; a fully-failing multi-doc half
        short-circuits its sibling — a lane-wide outage stays O(log B))
          │still failing
        OracleUnavailable(docs=<unlabeled ids>)  [partial successes are
        already cached and count as breaker liveness]
    """

    acts_as_cached = True

    def __init__(self, oracle, *, retry: RetryPolicy = RetryPolicy(),
                 breaker: BreakerConfig = BreakerConfig(), seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 on_half_open: Optional[Callable[[], None]] = None):
        self.cached = oracle if isinstance(oracle, CachedOracle) \
            else CachedOracle(oracle)
        self.inner = self.cached.inner
        self.retry = retry
        self.breaker = CircuitBreaker(breaker, clock=clock,
                                      on_half_open=on_half_open)
        self._rng = np.random.default_rng(seed)
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self.retries = 0            # backoff sleeps taken
        self.bisects = 0            # batch splits performed
        self.timeouts = 0           # OracleTimeout attempts observed
        self.faults = 0             # other OracleError attempts observed
        self.timeout_overruns = 0   # successful calls over call_timeout_s
        self.breaker_rejects = 0    # asks refused while open/probing
        self.gave_up_docs = 0       # docs surfaced in OracleUnavailable

    # -- CachedOracle surface (delegated) --------------------------------

    @property
    def calls(self):
        return self.cached.calls

    @property
    def queried(self):
        return self.cached.queried

    @property
    def cached_count(self):
        return self.cached.cached_count

    @property
    def hits(self):
        return self.cached.hits

    @property
    def purchases(self):
        return self.cached.purchases

    @property
    def docs_purchased(self):
        return self.cached.docs_purchased

    @property
    def flops_per_doc(self):
        return self.cached.flops_per_doc

    def peek(self, indices) -> Sequence[int]:
        return self.cached.peek(indices)

    def cached_positive_rate(self):
        return self.cached.cached_positive_rate()

    def stats(self) -> dict:
        return self.cached.stats()

    def resilience_stats(self) -> dict:
        with self._lock:
            out = {"retries": self.retries, "bisects": self.bisects,
                   "timeouts": self.timeouts, "faults": self.faults,
                   "timeout_overruns": self.timeout_overruns,
                   "breaker_rejects": self.breaker_rejects,
                   "gave_up_docs": self.gave_up_docs}
        out["breaker"] = self.breaker.status()
        return out

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    # -- label -----------------------------------------------------------

    def label(self, indices) -> np.ndarray:
        indices = np.asarray(indices, dtype=np.int64)
        missing = self.cached.peek(indices) if len(indices) else []
        if missing:
            # cache reads never touch the breaker: a session replaying
            # already-purchased labels must work during an outage
            self._purchase([int(i) for i in missing])
        return self.cached.label(indices)

    def _purchase(self, docs) -> None:
        allowed, retry_after = self.breaker.allow()
        if not allowed:
            self._count("breaker_rejects")
            trace_mod.add_event("oracle.breaker_reject", docs=len(docs),
                                retry_after=round(retry_after, 6))
            raise OracleUnavailable(
                f"oracle circuit open ({len(docs)} docs refused)",
                docs=docs, retry_after=retry_after, breaker_open=True)
        deadline = self._clock() + self.retry.deadline_s
        failed, last = self._acquire(list(docs), deadline, depth=0)
        if not failed:
            self.breaker.record_success()
            return
        self._count("gave_up_docs", len(failed))
        if len(failed) < len(docs):
            # some docs landed: the lane is alive, the inputs are not
            self.breaker.record_success()
            raise OracleUnavailable(
                f"oracle failed for {len(failed)}/{len(docs)} docs "
                f"(poison suspected)", docs=failed) from last
        self.breaker.record_failure()
        raise OracleUnavailable(
            f"oracle failed for all {len(docs)} docs",
            docs=failed, retry_after=self.breaker.retry_after()
            or self.breaker.cfg.cooldown_s) from last

    def _acquire(self, docs, deadline: float, depth: int):
        """Try to cache ``docs``; returns (failed_docs, last_exc).
        Retries with backoff at depth 0; deeper nodes get one attempt
        (the parent already burned the retry budget)."""
        failed_exc = self._attempts(docs, deadline, depth)
        if failed_exc is None:
            return [], None
        if not self.retry.bisect or len(docs) == 1:
            return list(docs), failed_exc
        self._count("bisects")
        trace_mod.add_event("oracle.bisect", docs=len(docs), depth=depth)
        mid = len(docs) // 2
        left, right = docs[:mid], docs[mid:]
        f1, l1 = self._acquire(left, deadline, depth + 1)
        if len(f1) == len(left) and len(left) > 1:
            # a multi-doc half failing outright is lane-wide, not
            # poison: short-circuit the sibling so a blackout costs
            # O(log B), not O(B), invocations
            return list(docs), l1 or failed_exc
        f2, l2 = self._acquire(right, deadline, depth + 1)
        return f1 + f2, l2 or l1 or failed_exc

    def _attempts(self, docs, deadline: float, depth: int):
        """One retry loop over an exact doc set. Returns None on
        success, else the last exception."""
        attempts = self.retry.max_attempts if depth == 0 else 1
        prev = self.retry.base_delay_s
        last: Optional[OracleError] = None
        for attempt in range(max(1, attempts)):
            if attempt:
                remaining = deadline - self._clock()
                if remaining <= 0:
                    break
                with self._lock:
                    prev = decorrelated_jitter(
                        self._rng, prev, self.retry.base_delay_s,
                        self.retry.max_delay_s)
                self._count("retries")
                trace_mod.add_event("oracle.retry", attempt=attempt,
                                    docs=len(docs),
                                    delay=round(min(prev, remaining), 6))
                self._sleep(min(prev, remaining))
            try:
                t0 = self._clock()
                # CachedOracle dedups under its lock: docs a sibling
                # half or another session already bought are not re-paid
                self.cached.label(np.asarray(docs, np.int64))
                if (self.retry.call_timeout_s
                        and self._clock() - t0 > self.retry.call_timeout_s):
                    self._count("timeout_overruns")
                return None
            except OracleTimeout as exc:
                self._count("timeouts")
                last = exc
            except OracleError as exc:
                self._count("faults")
                last = exc
            if self._clock() >= deadline:
                break
        return last
