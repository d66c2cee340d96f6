"""Oracle interfaces (a numpy copy of ``repro.core.oracle``).

* SimulatedOracle — planted ground-truth labels + optional flip noise +
  a FLOPs cost model (the paper's own Table 2 reports cost in FLOPs,
  which we mirror). Counts invocations.
* CachedOracle — memoizes purchased labels across a query's training,
  calibration and ambiguous-band asks (and across the leaves and
  sessions of the engine that shares it), with ``peek`` for decision
  provenance and hit / purchase counters.
* The oracle-plane errors: ``OracleError`` and its ``OracleFault``,
  ``OracleTimeout`` and ``OracleUnavailable``, which the engine's
  degraded modes catch and ``repro_torch.serve.resilience`` raises.
The LM-as-judge oracle of the JAX package is not ported yet.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np

# FLOPs cost model per document. Provenance: paper §6.2 (Table 2
# "computational cost" column) reports TOTAL FLOPs over a 10k-document
# collection of ~400-word documents; we normalize each per document.
#   oracle LLM (GPT-4o class)  >500 PFLOPs / 10k docs -> ~50 TFLOPs/doc
#   3B proxy-LLM baseline        27 PFLOPs / 10k docs
#   1B proxy-LLM baseline        10 PFLOPs / 10k docs
#   ScaleDoc MLP proxy           ~2 TFLOPs / 10k docs -> ~0.2 GFLOPs/doc
# (sanity check: ~2*params*tokens forward FLOPs at a few hundred tokens
# per document lands within ~2x of each row). QueryStats reports cost
# in these units; the ratios, not the absolute counts, carry the
# paper's story.
ORACLE_FLOPS_PER_DOC = 500e15 / 10_000
PROXY_LLM_3B_FLOPS_PER_DOC = 27e15 / 10_000
PROXY_LLM_1B_FLOPS_PER_DOC = 10e15 / 10_000
OUR_PROXY_FLOPS_PER_DOC = 2e12 / 10_000


class OracleError(RuntimeError):
    """Base for oracle-plane failures. Subclasses RuntimeError, as in the
    JAX package. Lives here (not in serve/) so the engine can catch it
    without importing the serving package."""


class OracleFault(OracleError):
    """A single invocation failed (drop, rate-limit, poison input).
    Retryable."""


class OracleTimeout(OracleFault):
    """An invocation exceeded its deadline. Retryable."""


class OracleUnavailable(OracleError):
    """The oracle plane gave up: retries/bisection exhausted or the
    circuit breaker is open. Carries the doc ids that were NOT labeled
    and an advisory retry-after horizon."""

    def __init__(self, message: str = "oracle unavailable", *,
                 docs: Sequence[int] = (), retry_after: float = 0.0,
                 breaker_open: bool = False):
        super().__init__(message)
        self.docs = tuple(int(d) for d in docs)
        self.retry_after = float(retry_after)
        self.breaker_open = bool(breaker_open)


class CachedOracle:
    """Memoizing wrapper: labels already purchased are never re-paid.
    The pipeline samples training, calibration and ambiguous-band labels
    independently; overlaps are common at high selectivity and should
    cost nothing.

    Thread-safe: the miss-check and the purchase happen under one lock,
    so two callers racing on the same document never both pay for it,
    and ``calls`` / ``queried`` / ``stats()`` snapshot the inner oracle
    under the same lock.
    """

    def __init__(self, inner):
        self.inner = inner
        self._cache = {}
        self._lock = threading.Lock()
        self.hits = 0            # per-doc label asks served from cache
        self.purchases = 0       # inner label() invocations
        self.docs_purchased = 0  # docs actually paid for (sum of misses)

    @property
    def calls(self):
        with self._lock:
            return self.inner.calls

    @property
    def queried(self):
        with self._lock:
            return set(self.inner.queried)

    @property
    def cached_count(self):
        with self._lock:
            return len(self._cache)

    def cached_positive_rate(self) -> Optional[float]:
        """Mean of the labels already purchased (None while the cache is
        empty): a free positive-rate estimate."""
        with self._lock:
            if not self._cache:
                return None
            return float(np.mean([bool(v) for v in self._cache.values()]))

    def stats(self) -> dict:
        """One atomic snapshot of calls / queried / cache size / hit
        accounting (reading the properties separately can interleave
        with a concurrent purchase)."""
        with self._lock:
            return {"calls": self.inner.calls,
                    "queried": len(getattr(self.inner, "queried", ())),
                    "cached": len(self._cache),
                    "hits": self.hits,
                    "purchases": self.purchases,
                    "docs_purchased": self.docs_purchased}

    @property
    def flops_per_doc(self):
        return getattr(self.inner, "flops_per_doc", ORACLE_FLOPS_PER_DOC)

    def peek(self, indices) -> Sequence[int]:
        """Indices (deduped, first-appearance order) not yet cached.
        Advisory only — another thread may purchase them between peek
        and label; ``label`` re-checks under the lock."""
        with self._lock:
            out, seen = [], set()
            for i in np.asarray(indices, dtype=np.int64):
                i = int(i)
                if i not in self._cache and i not in seen:
                    seen.add(i)
                    out.append(i)
            return out

    def label(self, indices):
        indices = np.asarray(indices, dtype=np.int64)
        with self._lock:
            missing = []
            seen = set()
            for i in indices:
                i = int(i)
                if i not in self._cache and i not in seen:
                    seen.add(i)
                    missing.append(i)
            if missing:
                got = self.inner.label(np.asarray(missing, dtype=np.int64))
                for i, v in zip(missing, got):
                    self._cache[i] = bool(v)
                self.purchases += 1
                self.docs_purchased += len(missing)
            # per-doc hit accounting: every unique doc in the ask that
            # did NOT need a purchase was served from cache, whether or
            # not the ask was fully cached. Counted only after a
            # successful purchase so a raising inner leaves stats
            # describing completed asks only.
            self.hits += len({int(i) for i in indices}) - len(missing)
            return np.array([self._cache[int(i)] for i in indices],
                            dtype=bool)


class SimulatedOracle:
    """Ground-truth labeler with invocation accounting."""

    def __init__(self, labels: np.ndarray, flip_noise: float = 0.0,
                 seed: int = 0,
                 flops_per_doc: float = ORACLE_FLOPS_PER_DOC):
        self._labels = np.asarray(labels).astype(bool)
        self._rng = np.random.default_rng(seed)
        self.flip_noise = flip_noise
        self.flops_per_doc = flops_per_doc
        self.calls = 0
        self.queried = set()

    def label(self, indices: Sequence[int]) -> np.ndarray:
        indices = np.asarray(indices, dtype=np.int64)
        self.calls += len(indices)
        self.queried.update(int(i) for i in indices)
        out = self._labels[indices].copy()
        if self.flip_noise > 0:
            flips = self._rng.random(len(indices)) < self.flip_noise
            out = out ^ flips
        return out
