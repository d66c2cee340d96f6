"""Standing predicates over live collections: incremental delta scoring
(a copy of ``repro.engine.live``).

The engine treats a collection as frozen: every proxy/decision cache
keys off a fixed corpus fingerprint, so one appended commit group
invalidates everything and the only recourse is a full re-``filter()``.
This module makes predicates *continuous queries* over an open store:

  * ``LiveEngine`` owns a watermark-aware ``DocumentStore`` (a
    directory-backed ``MemmapStore`` whose ``refresh()`` picks up rows a
    concurrent ``StoreWriter``/``Ingestor`` committed) plus a registry
    of ``StandingPredicate``s;
  * ``register()`` runs one ordinary ``ScaleDocEngine.filter()`` over
    the rows committed so far — the *calibration prefix* — and captures
    what the cascade learned: per-leaf trained proxy params and accept/
    reject thresholds ``(l, r)``;
  * ``pump()`` advances every standing predicate to the current
    watermark by scoring **only the delta rows** against the cached
    proxies (through the shared ``ScoringExecutor``, hence the fused
    scoring kernel on the card), auto-labeling outside ``(l, r)`` and
    oracle-labeling the ambiguous remainder — the cheapest query the
    system can run;
  * a drift monitor compares rolling delta selectivity and ambiguous-
    band fraction against the calibration snapshot and triggers
    ``revalidate()`` (recalibrate-then-retrain over the full collection)
    when the threshold guarantee can no longer be trusted;
  * subscribers receive one ``DeltaBatch`` of accepted/rejected doc ids
    per processed commit group (``revalidated=True`` batches replace
    all prior decisions).

Bit-parity contract (pinned by tests/test_torch_live.py)
----------------------------------------------------------------------
Every delta decision is **row-local**: a row's outcome is a function of
its embedding, the calibration state (proxy params + thresholds, fixed
at the last (re)calibration watermark) and the deterministic oracle —
never of which commit group delivered it or how pumps were interleaved.
Therefore decisions after any number of incremental batches are bitwise
identical to ``standing_filter()`` — one registration at the same
calibration watermark plus a single delta pass — and a ``revalidate()``
at watermark N makes them bitwise identical to a fresh one-shot
``ScaleDocEngine.filter()`` over the final committed store.

Row locality on the port's devices. The contract needs a row's score to
carry the same bits whatever tile delivers it. On the card the fused
kernel gives each block 64 rows of its own, loads rows past the tile's
end as zeros and guards its write, so a row's bits cannot depend on the
tile's length or on its neighbours; ``chip_smoke.py``'s ``[live]``
probe holds ragged delta tiles bitwise against one full pass, with and
without a pad. On the CPU the plain version's matrix products are
blocked by row count: the same row scored in tiles of different lengths
can differ by 1-2 ulp, while at one fixed length its bits do not depend
on its position in the tile. So on the CPU (``PAD_DEVICE_TYPES``) every
delta tile is scored at exactly the executor's ``chunk`` rows: the tail
tile is filled by repeating the range's last row, and the pad's scores
are discarded.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import uuid
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.config import CascadeConfig, ProxyConfig
from repro_torch.core.oracle import OracleError
from repro_torch.engine.engine import FilterResult, ScaleDocEngine
from repro_torch.engine.executor import ScoringStats
from repro_torch.engine.predicate import (FALSE, TRUE, UNKNOWN, Predicate,
                                          SemanticTopK)
from repro_torch.engine.store import DEFAULT_CHUNK, DocumentStore
from repro_torch.runtime import trace as trace_mod

# device types whose delta tiles are scored at one fixed row count (the
# module docstring's row-locality paragraph)
PAD_DEVICE_TYPES = ("cpu",)


class LiveEngineClosed(RuntimeError):
    """register()/pump() after close()."""


class StandingCancelled(RuntimeError):
    """The standing predicate was cancelled; no further batches."""


# ---------------------------------------------------------------------------
# store views
# ---------------------------------------------------------------------------

class RangeView(DocumentStore):
    """Read-only ``[lo, hi)`` window of a store, indexed from 0.

    Registration filters run over ``RangeView(store, 0, W)`` (the
    calibration prefix) and delta scoring over ``RangeView(store, lo,
    hi)`` — both stream chunk-by-chunk, so a window over an out-of-core
    collection never materializes more than one chunk."""

    def __init__(self, store: DocumentStore, lo: int, hi: int):
        if not 0 <= lo <= hi:
            raise ValueError(f"bad range [{lo}, {hi})")
        self._store = store
        self.lo = int(lo)
        self.hi = int(hi)

    def __len__(self) -> int:
        return self.hi - self.lo

    @property
    def dim(self) -> int:
        return self._store.dim

    def get(self, indices) -> np.ndarray:
        return self._store.get(self.lo + np.asarray(indices, np.int64))

    def iter_chunks(self, chunk: int = DEFAULT_CHUNK):
        for start in range(0, len(self), chunk):
            stop = min(start + chunk, len(self))
            yield start, self._store.get(
                np.arange(self.lo + start, self.lo + stop))


class _PadView(DocumentStore):
    """Rows ``[lo, hi)`` of a store, lengthened to a whole number of
    ``tile``-row tiles by repeating row ``hi - 1`` (see the module
    docstring: the CPU's plain scoring is row-local only at one fixed
    tile length). Indices past the range read its last row."""

    def __init__(self, store: DocumentStore, lo: int, hi: int, tile: int):
        if not 0 <= lo < hi or tile < 1:
            raise ValueError(f"bad padded range [{lo}, {hi}) / {tile}")
        self._view = RangeView(store, lo, hi)
        self._tile = int(tile)

    def __len__(self) -> int:
        return -(-len(self._view) // self._tile) * self._tile

    @property
    def dim(self) -> int:
        return self._view.dim

    def get(self, indices) -> np.ndarray:
        idx = np.minimum(np.asarray(indices, np.int64), len(self._view) - 1)
        return self._view.get(idx)

    def iter_chunks(self, chunk: int = DEFAULT_CHUNK):
        for start in range(0, len(self), chunk):
            stop = min(start + chunk, len(self))
            yield start, self.get(np.arange(start, stop))


def _score_rows(executor, params, e_q, store, lo: int, hi: int, *,
                pad: Optional[bool] = None):
    """Proxy scores for rows ``[lo, hi)`` -> ((hi-lo,) float32, stats).

    The one scoring entry point both the live pump and the one-shot
    ``standing_filter`` reference use, so their numerics cannot drift.
    ``pad`` (default: the executor's device type is in
    ``PAD_DEVICE_TYPES``) scores the rows in tiles of exactly the
    executor's ``chunk``; ``stats`` counts the pad rows it scored."""
    m = hi - lo
    if pad is None:
        pad = executor.device.type in PAD_DEVICE_TYPES
    view = (_PadView(store, lo, hi, executor.chunk) if pad and m
            else RangeView(store, lo, hi))
    scores, stats = executor.score(params, e_q, view)
    return scores[:m], stats


# ---------------------------------------------------------------------------
# configuration + wire records
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """When does a standing predicate stop trusting its calibration?

    The monitor keeps a rolling window of the last ``window`` delta-row
    outcomes and compares two statistics against the snapshot taken at
    calibration time: the accept rate (selectivity) and the fraction of
    rows the proxy could not auto-decide (the ambiguous band at the
    root). Either deviating by more than its slack — once at least
    ``min_rows`` have been observed since calibration — trips the
    trigger; with ``auto=True`` the engine immediately revalidates
    (recalibrate + retrain over the full collection). ``auto=False``
    only surfaces the trigger through ``drift_status()`` — the mode the
    parity harness runs, since an auto-revalidation fires at an
    interleaving-dependent watermark."""
    window: int = 4096
    min_rows: int = 512
    selectivity_slack: float = 0.2
    ambiguous_slack: float = 0.2
    auto: bool = True


@dataclasses.dataclass
class DeltaBatch:
    """One pushed increment of standing-predicate decisions.

    ``accepted``/``rejected`` are global doc ids. A ``revalidated``
    batch re-states the *entire* collection (``lo=0``): subscribers must
    replace, not append. ``rows_scored`` counts (row, leaf) proxy
    scorings charged to this batch — the counter the tests use to prove
    only delta rows were scored; ``oracle_calls`` counts labels
    purchased resolving the batch's ambiguous rows."""
    seq: int
    lo: int
    hi: int
    accepted: np.ndarray
    rejected: np.ndarray
    rows_scored: int = 0
    oracle_calls: int = 0
    revalidated: bool = False
    final: bool = False


@dataclasses.dataclass
class _LeafState:
    """What calibration froze for one leaf: the proxy to score deltas
    with and the thresholds to auto-decide them against. ``params`` is
    None in the direct-label regime (calibration prefix below the
    cascade cutoff); thresholds are None when the plan short-circuited
    before this leaf ran a cascade — either way every delta row of this
    leaf is ambiguous and goes to the oracle."""
    key: str
    name: str
    e_q: np.ndarray
    oracle: object
    params: Optional[Dict] = None
    l: Optional[float] = None
    r: Optional[float] = None

    @property
    def scorable(self) -> bool:
        return self.params is not None and self.l is not None


# ---------------------------------------------------------------------------
# subscriptions
# ---------------------------------------------------------------------------

class Subscription:
    """Consumer handle: iterate (or ``get()``) ``DeltaBatch``es as
    commit groups are processed; ends at the ``final`` batch pushed by
    cancel/close. Queues are unbounded — batches are id lists, and a
    slow consumer must never stall the pump."""

    def __init__(self, standing: "StandingPredicate"):
        self.standing = standing
        self._q: "queue.Queue[DeltaBatch]" = queue.Queue()
        self.closed = False

    def _push(self, batch: DeltaBatch) -> None:
        if not self.closed:
            self._q.put(batch)
            if batch.final:
                self.closed = True

    def get(self, timeout: Optional[float] = None) -> DeltaBatch:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"{self.standing.name}: no delta batch within "
                f"{timeout}s") from None

    def __iter__(self):
        while True:
            batch = self._q.get()
            yield batch
            if batch.final:
                return

    def close(self) -> None:
        """Stop receiving batches (the predicate itself keeps running)."""
        self.standing._drop_subscription(self)


# ---------------------------------------------------------------------------
# standing predicate
# ---------------------------------------------------------------------------

class StandingPredicate:
    """One registered continuous query: calibration state + decisions so
    far + drift monitor + subscriber fan-out. All mutation happens under
    the owning ``LiveEngine``'s lock."""

    def __init__(self, live: "LiveEngine", predicate: Predicate, *,
                 seed: int, name: Optional[str],
                 accuracy_target: Optional[float],
                 drift: DriftConfig):
        self.id = uuid.uuid4().hex[:12]
        self.live = live
        self.predicate = predicate
        self.seed = seed
        self.name = name or f"standing-{self.id[:6]}"
        self.accuracy_target = accuracy_target
        self.drift_cfg = drift
        self._lock = live._lock
        # calibration state (set by LiveEngine._calibrate)
        self._leaves: List[_LeafState] = []
        self._decisions = np.zeros(0, bool)
        self.calib_rows = 0
        self.watermark = 0
        self._snapshot = {"selectivity": 0.5, "ambiguous": 0.0}
        self._window: deque = deque(maxlen=drift.window)
        # accounting
        self.seq = 0
        self.delta_batches = 0
        self.rows_scored_total = 0          # delta (row, leaf) scorings
        self.oracle_calls_delta = 0
        self.revalidations = 0
        self.drift_trips = 0
        self.pumps_stalled = 0              # oracle-outage non-advances
        self.calibration_oracle_calls = 0
        self.scoring_stats = ScoringStats()
        self.cancelled = False
        self._subs: List[Subscription] = []

    # -- consumer surface -------------------------------------------------

    @property
    def decisions(self) -> np.ndarray:
        """Boolean mask over rows ``[0, watermark)`` — accepted docs."""
        with self._lock:
            return self._decisions.copy()

    def accepted_ids(self) -> np.ndarray:
        with self._lock:
            return np.nonzero(self._decisions)[0]

    def subscribe(self) -> Subscription:
        with self._lock:
            if self.cancelled:
                raise StandingCancelled(f"{self.name} is cancelled")
            sub = Subscription(self)
            self._subs.append(sub)
            return sub

    def revalidate(self) -> DeltaBatch:
        """Recalibrate + retrain over the full committed collection."""
        return self.live.revalidate(self)

    def cancel(self) -> bool:
        return self.live.unregister(self)

    def done(self) -> bool:
        return self.cancelled

    def drift_status(self) -> Dict:
        """Rolling window vs calibration snapshot; ``triggered`` is what
        ``auto`` mode acts on."""
        with self._lock:
            rows = len(self._window)
            if rows:
                acc = sum(a for a, _ in self._window)
                amb = sum(b for _, b in self._window)
                sel, ambf = acc / rows, amb / rows
            else:
                sel = self._snapshot["selectivity"]
                ambf = self._snapshot["ambiguous"]
            cfg = self.drift_cfg
            sel_drift = abs(sel - self._snapshot["selectivity"])
            amb_drift = ambf - self._snapshot["ambiguous"]
            triggered = rows >= cfg.min_rows and (
                sel_drift > cfg.selectivity_slack
                or amb_drift > cfg.ambiguous_slack)
            return {"rows": rows, "selectivity": sel,
                    "ambiguous": ambf,
                    "snapshot": dict(self._snapshot),
                    "selectivity_drift": sel_drift,
                    "ambiguous_drift": amb_drift,
                    "triggered": triggered}

    def stats(self) -> Dict:
        with self._lock:
            return {
                "id": self.id, "name": self.name,
                "state": "cancelled" if self.cancelled else "live",
                "watermark": self.watermark,
                "calib_rows": self.calib_rows,
                "accepted": int(self._decisions.sum()),
                "rejected": int((~self._decisions).sum()),
                "delta_batches": self.delta_batches,
                "rows_scored_total": self.rows_scored_total,
                "oracle_calls_delta": self.oracle_calls_delta,
                "calibration_oracle_calls": self.calibration_oracle_calls,
                "revalidations": self.revalidations,
                "drift_trips": self.drift_trips,
                "pumps_stalled": self.pumps_stalled,
                "subscribers": len(self._subs),
                "drift": self.drift_status(),
            }

    # -- engine-side plumbing (lock held by caller) -----------------------

    def _publish(self, batch: DeltaBatch) -> None:
        for sub in list(self._subs):
            sub._push(batch)

    def _drop_subscription(self, sub: Subscription) -> None:
        with self._lock:
            sub.closed = True
            if sub in self._subs:
                self._subs.remove(sub)


# ---------------------------------------------------------------------------
# live engine
# ---------------------------------------------------------------------------

class LiveEngine:
    """Registry of standing predicates over an open, growing store.

    Wraps (or builds, on ``device``: ``"cuda"`` by default) a
    ``ScaleDocEngine``; registration and revalidation run ordinary
    ``filter()`` calls on isolated session views, so all the engine's
    machinery — cost-ordered plans, batched training, executor
    streaming — is reused unchanged. One RLock serializes
    register/pump/revalidate: callers may pump from any thread (the soak
    harness does), decisions never depend on who wins.
    """

    def __init__(self, engine_or_store,
                 proxy_cfg: Optional[ProxyConfig] = None,
                 cascade_cfg: Optional[CascadeConfig] = None, *,
                 drift: Optional[DriftConfig] = None, **engine_kwargs):
        if isinstance(engine_or_store, ScaleDocEngine):
            self.engine = engine_or_store
        else:
            self.engine = ScaleDocEngine(engine_or_store, proxy_cfg,
                                         cascade_cfg, **engine_kwargs)
        self.store = self.engine.store
        self.drift_cfg = drift or DriftConfig()
        # observability: the serving layer attaches its tracer so pump
        # cycles appear in the flight recorder (spans never affect
        # decisions)
        self.tracer = trace_mod.NULL_TRACER
        self._standing: Dict[str, StandingPredicate] = {}
        self._lock = threading.RLock()
        self._closed = False

    # -- registry ---------------------------------------------------------

    def register(self, predicate: Predicate, *, seed: int = 0,
                 name: Optional[str] = None,
                 accuracy_target: Optional[float] = None,
                 drift: Optional[DriftConfig] = None,
                 calib_rows: Optional[int] = None) -> StandingPredicate:
        """Register a continuous query.

        Calibrates over the rows committed so far (after a store
        refresh): one ``filter()`` on a fresh session view over the
        prefix, capturing per-leaf proxy params, thresholds and the
        drift snapshot. ``calib_rows`` caps the calibration prefix —
        the replay/parity hook: registering at an earlier watermark and
        pumping reproduces a predicate that lived through ingestion.
        """
        if not isinstance(predicate, Predicate):
            raise TypeError("predicate must be a repro_torch.engine "
                            "Predicate")
        if isinstance(predicate, SemanticTopK):
            # a global top-k changes membership retroactively as rows
            # arrive — there is no delta-only evaluation for it
            raise TypeError("SemanticTopK cannot be a standing "
                            "predicate; filter() it over a snapshot")
        with self._lock:
            if self._closed:
                raise LiveEngineClosed("LiveEngine is closed")
            n = self._refresh()
            rows = n if calib_rows is None else min(int(calib_rows), n)
            sp = StandingPredicate(
                self, predicate, seed=seed, name=name,
                accuracy_target=accuracy_target,
                drift=drift or self.drift_cfg)
            self._calibrate(sp, rows)
            self._standing[sp.id] = sp
            return sp

    def get(self, standing_id: str) -> Optional[StandingPredicate]:
        with self._lock:
            return self._standing.get(standing_id)

    def standing(self) -> List[StandingPredicate]:
        with self._lock:
            return list(self._standing.values())

    def unregister(self, sp: StandingPredicate) -> bool:
        """Cancel: push the final sentinel batch and drop the predicate
        from the registry. Idempotent."""
        with self._lock:
            if sp.cancelled:
                return False
            sp.cancelled = True
            self._standing.pop(sp.id, None)
            sp._publish(DeltaBatch(
                seq=sp.seq, lo=sp.watermark, hi=sp.watermark,
                accepted=np.zeros(0, np.int64),
                rejected=np.zeros(0, np.int64), final=True))
            sp.seq += 1
            return True

    # -- the pump ---------------------------------------------------------

    def pump(self) -> int:
        """Refresh the store and advance every standing predicate to the
        new watermark, one ``DeltaBatch`` per predicate per call.
        Returns the committed row count. Call it after each ingest
        commit group (or on a timer); a pump that observes several
        commit groups folds them into one batch — decisions are
        batching-invariant, only delivery granularity changes."""
        with self._lock:
            if self._closed:
                raise LiveEngineClosed("LiveEngine is closed")
            n = self._refresh()
            with self.tracer.span("live.pump", kind="live",
                                  watermark=n,
                                  standing=len(self._standing)) as pspan:
                return self._pump_locked(n, pspan)

    def _pump_locked(self, n: int, pspan) -> int:
        stalled = 0
        for sp in list(self._standing.values()):
            if sp.watermark < n:
                try:
                    with self.tracer.span(
                            "live.delta", kind="live",
                            standing=sp.name or sp.id,
                            lo=int(sp.watermark), hi=int(n)):
                        self._process_delta(sp, sp.watermark, n)
                except OracleError:
                    # oracle outage mid-delta: non-advancing pump.
                    # _process_delta commits nothing before its
                    # labeling completes, so the watermark is
                    # unmoved, no batch was published, and the same
                    # rows are retried next pump. The drift check is
                    # skipped too — its window never saw these rows,
                    # so an outage cannot masquerade as drift.
                    sp.pumps_stalled += 1
                    stalled += 1
                    continue
                if sp.drift_cfg.auto and not sp.cancelled:
                    if sp.drift_status()["triggered"]:
                        sp.drift_trips += 1
                        try:
                            with self.tracer.span(
                                    "live.revalidate", kind="live",
                                    standing=sp.name or sp.id):
                                self._revalidate_locked(sp, n)
                        except OracleError:
                            # drift stays triggered; retried on the
                            # next pump that advances the watermark
                            sp.pumps_stalled += 1
                            stalled += 1
        if stalled:
            pspan.set(stalled=stalled)
        return n

    def revalidate(self, sp: StandingPredicate) -> DeltaBatch:
        """Recalibrate-then-retrain ``sp`` over the full committed
        collection and push a ``revalidated=True`` batch re-stating
        every decision. After this, ``sp.decisions`` is bitwise what a
        fresh ``ScaleDocEngine.filter()`` over the store would return."""
        with self._lock:
            if sp.cancelled:
                raise StandingCancelled(f"{sp.name} is cancelled")
            return self._revalidate_locked(sp, self._refresh())

    def close(self) -> None:
        """Cancel every standing predicate (final batches flow to
        subscribers) and refuse further work."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for sp in list(self._standing.values()):
                self.unregister(sp)

    def __enter__(self) -> "LiveEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- internals (lock held) --------------------------------------------

    def _refresh(self) -> int:
        refresh = getattr(self.store, "refresh", None)
        if refresh is not None:
            return int(refresh())
        return len(self.store)

    def _calibrate(self, sp: StandingPredicate, rows: int) -> FilterResult:
        """(Re)run the registration filter over ``[0, rows)`` and freeze
        its cascade state into ``sp``. A fresh session view keeps the
        run bit-identical to a serial filter() on a fresh engine — the
        decision cache key has no row count, so reusing a view across
        watermarks would serve stale full-collection entries."""
        view = self.engine.session_view()
        view.store = RangeView(self.store, 0, rows)
        # degrade="fail" always: calibration state must come from a
        # fully-resolved run — a deferred partial would freeze wrong
        # decisions into sp. pump() catches the OracleError instead.
        res = view.filter(sp.predicate,
                          accuracy_target=sp.accuracy_target,
                          seed=sp.seed, degrade="fail")
        reports = {r.key: r for r in res.leaf_reports}
        # oracle-resolution order for delta rows = the plan order the
        # registration executed, then any leaves it short-circuited past
        ordered = [r.key for r in res.leaf_reports]
        leaves_by_key = {leaf.key: leaf for leaf in sp.predicate.leaves()}
        ordered += [k for k in leaves_by_key if k not in ordered]
        states = []
        for key in ordered:
            leaf = leaves_by_key[key]
            rep = reports.get(key)
            casc = rep.cascade if rep is not None else None
            states.append(_LeafState(
                key=key, name=leaf.name, e_q=leaf.e_q,
                oracle=self.engine._cached_oracle(leaf.oracle),
                params=view._proxies.get(key),
                l=None if casc is None else casc.l,
                r=None if casc is None else casc.r))
        sp._leaves = states
        sp._decisions = res.mask.astype(bool).copy()
        sp.calib_rows = rows
        sp.watermark = rows
        sp.calibration_oracle_calls += res.oracle_calls_total
        # drift snapshot: prefix accept rate, plus the fraction of
        # (row, leaf) decisions the cascade deferred to the oracle —
        # the heuristic baseline the rolling window is judged against
        amb = sum(r.n_pending * r.cascade.unfiltered_rate
                  for r in res.leaf_reports if r.cascade is not None)
        sp._snapshot = {
            "selectivity": float(res.mask.mean()) if rows else 0.5,
            "ambiguous": amb / rows if rows else 0.0,
        }
        sp._window.clear()
        return res

    def _process_delta(self, sp: StandingPredicate, lo: int,
                       hi: int) -> DeltaBatch:
        """Decide rows ``[lo, hi)`` with calibration state only — the
        row-local algorithm the parity contract rests on.

        1. score each calibrated leaf's proxy over the delta rows and
           auto-decide outside ``(l, r)`` (TRUE above r, FALSE below l);
        2. Kleene-evaluate the root; rows still UNKNOWN form the
           ambiguous band;
        3. walk leaves in calibration plan order, oracle-labeling each
           leaf's still-needed rows until the root decides everywhere
           (short-circuit: a row decided by an earlier leaf's label
           never buys a later leaf's).
        """
        m = hi - lo
        vals: Dict[str, np.ndarray] = {}
        rows_scored = 0
        for ls in sp._leaves:
            v = np.full(m, UNKNOWN, np.int8)
            if ls.scorable:
                scores, stats = _score_rows(
                    self.engine.executor, ls.params, ls.e_q,
                    self.store, lo, hi)
                sp.scoring_stats.merge(stats)
                v[scores > ls.r] = TRUE
                v[scores < ls.l] = FALSE
                rows_scored += m
            vals[ls.key] = v
        root = sp.predicate.evaluate(vals)
        ambiguous = root == UNKNOWN
        oracle_calls = 0
        for ls in sp._leaves:
            need = np.nonzero((root == UNKNOWN)
                              & (vals[ls.key] == UNKNOWN))[0]
            if not len(need):
                continue
            before = ls.oracle.calls
            labels = np.asarray(ls.oracle.label(lo + need))
            oracle_calls += ls.oracle.calls - before
            vals[ls.key][need] = labels.astype(np.int8)
            root = sp.predicate.evaluate(vals)
            if not (root == UNKNOWN).any():
                break
        assert not (root == UNKNOWN).any(), \
            "every leaf labeled yet delta rows left undecided"

        mask = root == TRUE
        sp._decisions = np.concatenate([sp._decisions, mask])
        sp.watermark = hi
        sp.delta_batches += 1
        sp.rows_scored_total += rows_scored
        sp.oracle_calls_delta += oracle_calls
        sp._window.extend(zip(mask.tolist(), ambiguous.tolist()))
        batch = DeltaBatch(
            seq=sp.seq, lo=lo, hi=hi,
            accepted=lo + np.nonzero(mask)[0],
            rejected=lo + np.nonzero(~mask)[0],
            rows_scored=rows_scored, oracle_calls=oracle_calls)
        sp.seq += 1
        sp._publish(batch)
        return batch

    def _revalidate_locked(self, sp: StandingPredicate,
                           n: int) -> DeltaBatch:
        calls0 = sp.calibration_oracle_calls
        res = self._calibrate(sp, n)
        sp.revalidations += 1
        batch = DeltaBatch(
            seq=sp.seq, lo=0, hi=n,
            accepted=np.nonzero(sp._decisions)[0],
            rejected=np.nonzero(~sp._decisions)[0],
            rows_scored=res.scoring_stats.docs_scored,
            oracle_calls=sp.calibration_oracle_calls - calls0,
            revalidated=True)
        sp.seq += 1
        sp._publish(batch)
        return batch


# ---------------------------------------------------------------------------
# one-shot reference
# ---------------------------------------------------------------------------

def standing_filter(store, predicate: Predicate, *, seed: int = 0,
                    calib_rows: Optional[int] = None,
                    proxy_cfg: Optional[ProxyConfig] = None,
                    cascade_cfg: Optional[CascadeConfig] = None,
                    accuracy_target: Optional[float] = None,
                    **engine_kwargs) -> StandingPredicate:
    """One-shot reference for the live path: calibrate at ``calib_rows``
    (default: the whole collection) and absorb the remaining rows as a
    single delta batch.

    Because delta decisions are row-local, the returned ``decisions``
    are bitwise identical to *any* incremental batching of the same
    rows with the same calibration watermark — the anchor the parity
    harness compares live runs against. With the tail empty
    (``calib_rows=None``) it degenerates to a plain fresh
    ``ScaleDocEngine.filter()`` over the store. ``engine_kwargs`` reach
    the ``ScaleDocEngine`` (``device``, ``chunk``, ``executor``, ...)."""
    live = LiveEngine(store, proxy_cfg, cascade_cfg,
                      drift=DriftConfig(auto=False), **engine_kwargs)
    sp = live.register(predicate, seed=seed,
                       accuracy_target=accuracy_target,
                       calib_rows=calib_rows)
    live.pump()
    return sp
