"""Cross-query optimizer: shared-leaf CSE + cross-session selectivity
(a copy of ``repro.engine.optimizer``).

The serving layer runs many compound predicates concurrently, and real
workloads share structure — two tenants asking ``"about GPUs" & ~spam``
and ``"about GPUs" | urgent`` both contain the *same* semantic leaf
(identical sha1 leaf key). Per-session execution pays the leaf's proxy
training pass and full-collection scoring pass once per session; the
broker only dedups the oracle *labels*. This module lifts optimization
to the server:

``SelectivityStats``
    The per-session ``_sel_est`` dict promoted to a thread-safe,
    server-owned table. Two observation levels with strict precedence:
    *measured* values (derived from a completed leaf calibration:
    threshold pass rates weighted by the calibration sample's positive
    rate inside the ambiguous band) always beat *estimated* ones (the
    planner's oracle-free cosine-mass heuristic). Plan ordering reads
    measured-else-nothing; estimated entries exist for observability
    (``/v1/metrics``) and as the fallback the proxy-fallback degrade
    path cuts against.

``QueryOptimizer``
    Common-subexpression elimination over in-flight plans. The unit of
    sharing is the *leaf artifact* — trained proxy params, the
    full-collection score vector, and the calibrated accept/reject
    thresholds, keyed by ``(leaf.key, strategy, cascade_cfg, seed)``.
    Because the engine derives every leaf's training sample, train key
    and calibration rng purely from ``(seed, leaf fingerprint)``
    (position-independent), an artifact is a pure function of its key:
    whichever session builds it, the result is bitwise identical to the
    session building it alone. Sharing therefore changes *cost only*,
    never decisions — the parity argument that
    tests/test_torch_compound.py pins generatively.

    Concurrent sessions needing the same missing artifact coalesce
    through single-flight claims (broker-style): the first claimant
    computes, the rest block on the flight and receive the published
    value. Owners never wait while holding an unbuilt claim (claims are
    taken immediately before building), so flights cannot deadlock; an
    owner that fails aborts the flight and waiters fall back to
    computing locally.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.runtime import trace as trace_mod

# a waiter gives up on a wedged flight owner and computes locally after
# this many seconds — liveness guard, not a tuning knob
FLIGHT_TIMEOUT = 600.0

MEASURED = "measured"
ESTIMATED = "estimated"


class SelectivityStats:
    """Thread-safe per-leaf selectivity table with measured-beats-
    estimated precedence. Keys are leaf cache keys (sha1 of e_q +
    oracle identity)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, tuple] = {}   # key -> (level, value, name)
        self._observations = {MEASURED: 0, ESTIMATED: 0}

    def observe(self, key: str, value: float, *, measured: bool,
                name: Optional[str] = None) -> None:
        level = MEASURED if measured else ESTIMATED
        with self._lock:
            self._observations[level] += 1
            got = self._entries.get(key)
            if got is not None and got[0] == MEASURED and not measured:
                return                      # estimated never demotes measured
            self._entries[key] = (level, float(value),
                                  name or (got[2] if got else None))

    def get(self, key: str, *,
            measured_only: bool = False) -> Optional[float]:
        with self._lock:
            got = self._entries.get(key)
        if got is None:
            return None
        if measured_only and got[0] != MEASURED:
            return None
        return got[1]

    def level(self, key: str) -> Optional[str]:
        with self._lock:
            got = self._entries.get(key)
        return got[0] if got else None

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def snapshot(self, max_entries: int = 64) -> Dict:
        with self._lock:
            entries = dict(self._entries)
            obs = dict(self._observations)
        measured = sum(1 for lv, _, _ in entries.values() if lv == MEASURED)
        out = {
            "leaves": len(entries),
            "measured": measured,
            "estimated": len(entries) - measured,
            "observations": obs,
            "entries": {
                key: {"level": lv, "selectivity": round(val, 6),
                      "name": nm}
                for key, (lv, val, nm)
                in sorted(entries.items())[:max_entries]
            },
        }
        return out


@dataclass
class LeafArtifact:
    """Everything one canonical leaf evaluation produced, full-collection
    granularity. ``labels_full`` is set for strategies without a
    threshold split (``probe``, custom registrations): their decisions
    are materialized eagerly and resolution is a slice. Threshold
    strategies leave it None — a document's decision is the pure
    function accept(s>r) / reject(s<l) / oracle(band), resolved lazily
    against whatever pending set a session brings."""
    key: str
    name: str
    scores: np.ndarray                  # (N,) proxy scores
    params: Optional[Dict]              # proxy params scored with
    l: float = 0.0
    r: float = 1.0
    sample_idx: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    sample_labels: np.ndarray = field(
        default_factory=lambda: np.zeros(0, bool))
    est_accuracy: Optional[float] = None
    certified: Optional[bool] = None
    calib_calls: int = 0                # labels its construction bought
    labels_full: Optional[np.ndarray] = None
    online_calls_full: int = 0          # band labels bought eagerly
    measured_sel: float = 0.5
    trained: bool = False               # construction trained the proxy


class _Flight:
    __slots__ = ("done", "value", "error")

    def __init__(self):
        self.done = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None


class QueryOptimizer:
    """Server-owned shared caches + single-flight coalescing.

    Session views handed an optimizer resolve proxies and leaf
    artifacts through it; everything here is advisory for *cost* —
    correctness never depends on who populated a cache first, because
    every cached value is a pure function of its key.
    """

    def __init__(self, stats: Optional[SelectivityStats] = None, *,
                 cse: bool = True):
        self.stats = stats or SelectivityStats()
        # cse=False keeps the shared SelectivityStats and the counters
        # but disables the shared caches: every session computes its own
        # proxies/artifacts. The plan-equivalence harness uses it as the
        # "optimizer off" arm — identical stats evolution (hence
        # identical plans), CSE the only difference between the runs.
        self.cse = cse
        self._lock = threading.Lock()
        self._proxies: Dict[Tuple[str, int], Dict] = {}
        self._artifacts: Dict[tuple, LeafArtifact] = {}
        self._flights: Dict[tuple, _Flight] = {}
        # counters (read via snapshot())
        self.proxies_trained = 0        # actual train events, fleet-wide
        self.proxy_hits = 0             # train passes CSE eliminated
        self.artifacts_built = 0
        self.artifact_hits = 0          # score+calibrate passes eliminated
        self.flights_joined = 0         # concurrent coalesced computations
        self.flight_fallbacks = 0       # aborted/timed-out flights
        self.topk_queries = 0

    # -- generic single-flight machinery ---------------------------------

    def _claim(self, cache: Dict, fkey: tuple, key):
        with self._lock:
            if key in cache:
                return "hit", cache[key]
            fl = self._flights.get(fkey)
            if fl is None:
                fl = _Flight()
                self._flights[fkey] = fl
                return "owner", fl
            self.flights_joined += 1
            return "wait", fl

    def _publish(self, cache: Dict, fkey: tuple, key, value) -> None:
        with self._lock:
            cache[key] = value
            fl = self._flights.pop(fkey, None)
        if fl is not None:
            fl.value = value
            fl.done.set()

    def _abort(self, fkey: tuple, exc: BaseException) -> None:
        with self._lock:
            fl = self._flights.pop(fkey, None)
        if fl is not None:
            fl.error = exc
            fl.done.set()

    @staticmethod
    def wait(flight: _Flight):
        """Block on a foreign flight; returns the published value or
        None when the owner aborted / the wait timed out (caller then
        computes locally). The blocked time lands on the waiting
        session's current span: it is exactly the latency CSE trades
        for the owner's saved compute."""
        t0 = time.perf_counter()
        ok = flight.done.wait(timeout=FLIGHT_TIMEOUT)
        trace_mod.add_event(
            "cse.flight_wait",
            seconds=round(time.perf_counter() - t0, 6),
            outcome=("timeout" if not ok
                     else "aborted" if flight.error is not None
                     else "joined"))
        if not ok:
            return None
        if flight.error is not None:
            return None
        return flight.value

    # -- proxies ----------------------------------------------------------

    def proxy(self, key: str, seed: int) -> Optional[Dict]:
        if not self.cse:
            return None
        with self._lock:
            got = self._proxies.get((key, seed))
            if got is not None:
                self.proxy_hits += 1
            return got

    def claim_proxy(self, key: str, seed: int):
        if not self.cse:
            return "owner", None
        kind = self._claim(self._proxies, ("proxy", key, seed),
                           (key, seed))
        if kind[0] == "hit":
            with self._lock:
                self.proxy_hits += 1
        return kind

    def publish_proxy(self, key: str, seed: int, params: Dict) -> None:
        with self._lock:
            self.proxies_trained += 1
        if self.cse:
            self._publish(self._proxies, ("proxy", key, seed), (key, seed),
                          params)

    def abort_proxy(self, key: str, seed: int, exc: BaseException) -> None:
        if not self.cse:
            return
        with self._lock:
            self.flight_fallbacks += 1
        self._abort(("proxy", key, seed), exc)

    # -- leaf artifacts ---------------------------------------------------

    def has_artifact(self, akey: tuple) -> bool:
        """Non-counting peek (the training phase uses it to skip proxy
        work for leaves whose artifact already exists)."""
        if not self.cse:
            return False
        with self._lock:
            return akey in self._artifacts

    def artifact(self, akey: tuple) -> Optional[LeafArtifact]:
        if not self.cse:
            return None
        with self._lock:
            got = self._artifacts.get(akey)
            if got is not None:
                self.artifact_hits += 1
            return got

    def claim_artifact(self, akey: tuple):
        if not self.cse:
            return "owner", None
        kind = self._claim(self._artifacts, ("artifact",) + akey, akey)
        if kind[0] == "hit":
            with self._lock:
                self.artifact_hits += 1
        return kind

    def publish_artifact(self, akey: tuple, art: LeafArtifact) -> None:
        with self._lock:
            self.artifacts_built += 1
        if self.cse:
            self._publish(self._artifacts, ("artifact",) + akey, akey, art)
        self.stats.observe(art.key, art.measured_sel, measured=True,
                           name=art.name)

    def abort_artifact(self, akey: tuple, exc: BaseException) -> None:
        if not self.cse:
            return
        with self._lock:
            self.flight_fallbacks += 1
        self._abort(("artifact",) + akey, exc)

    # -- observability ----------------------------------------------------

    def clear(self) -> None:
        """Drop shared caches (flights in progress are left to finish)."""
        with self._lock:
            self._proxies.clear()
            self._artifacts.clear()
        self.stats.clear()

    def snapshot(self) -> Dict:
        with self._lock:
            out = {
                "enabled": True,
                "cse": self.cse,
                "proxies_trained": self.proxies_trained,
                "proxy_hits": self.proxy_hits,
                "artifacts_built": self.artifacts_built,
                "artifact_hits": self.artifact_hits,
                "flights_joined": self.flights_joined,
                "flight_fallbacks": self.flight_fallbacks,
                "topk_queries": self.topk_queries,
                "cached_proxies": len(self._proxies),
                "cached_artifacts": len(self._artifacts),
            }
        out["selectivity"] = self.stats.snapshot()
        return out
