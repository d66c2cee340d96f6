"""OracleBroker: cross-session oracle micro-batching (a copy of
``repro.serve.broker``).

Every oracle ask an in-flight query session makes (training sample,
calibration sample, ambiguous band) routes through here instead of
hitting the oracle LLM directly. The broker keeps one *lane* per shared
``CachedOracle`` and coalesces concurrent asks into shared micro-batches:

  * **dedup** — a document already cached costs nothing; a document
    already sitting in an open or in-flight batch (asked by another
    session) is *joined*, not re-purchased;
  * **coalesce** — new misses accumulate in the lane's open batch, which
    flushes once it holds ``max_batch`` documents (a trigger, not a cap:
    one oversized ask still goes out as one invocation) or when its
    deadline (``max_delay`` seconds after the first miss was enqueued)
    expires;
  * **futures** — sessions block on the batch's completion event; labels
    land in the shared ``CachedOracle`` so the post-flush read is a pure
    cache hit.

Flushing is cooperative — there is no broker thread. The session that
fills a batch flushes it inline; otherwise the earliest-waiting session
flushes at the deadline (waiters wake on a timeout and check). Sessions
are blocked anyway while their labels are outstanding, so handing them
the flush work adds no latency and removes a thread lifecycle.

Correctness: labels are only ever *read* from the ``CachedOracle``,
whose lock guarantees each document is purchased at most once per
oracle. Batching therefore changes when and how the oracle is invoked
(fewer, fuller invocations) but never which labels a session sees —
the serving layer's bit-parity with serial ``filter()`` rests on this.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.oracle import CachedOracle, OracleUnavailable
from repro_torch.runtime import trace as trace_mod
from repro_torch.runtime.metrics import CounterSet

DEFAULT_MAX_BATCH = 32
DEFAULT_MAX_DELAY = 0.002       # seconds an open batch may age

# a coalesced flush links the spans of every session whose ask landed in
# the batch; bounded so a pathological fan-in cannot bloat the span
MAX_FLUSH_LINKS = 64


class _Batch:
    """One micro-batch being assembled or flushed."""

    __slots__ = ("docs", "created", "deadline", "event", "error",
                 "contributors")

    def __init__(self, deadline: float):
        self.docs: List[int] = []
        self.created = time.perf_counter()
        self.deadline = self.created + deadline
        self.event = threading.Event()
        self.error: Optional[BaseException] = None
        # span contexts of the sessions that enqueued or joined — the
        # flush span *links* (not parents) each of them, reconnecting
        # the coalesced oracle invocation to every tree it served
        self.contributors: List[trace_mod.SpanContext] = []


class _OracleLane:
    """Per-oracle batching state: one open batch plus the in-flight map."""

    def __init__(self, cached: CachedOracle, max_batch: int,
                 max_delay: float, counters: CounterSet,
                 broker: Optional["OracleBroker"] = None):
        self.cached = cached
        self.max_batch = max_batch
        self.max_delay = max_delay
        self.counters = counters
        # back-reference for the tracer: the broker's tracer can be
        # attached after lanes exist, so resolve it per flush
        self._broker = broker
        self._lock = threading.Lock()
        self._open: Optional[_Batch] = None
        # doc -> batch it will be purchased in (open or in flight)
        self._pending: Dict[int, _Batch] = {}

    @property
    def _tracer(self) -> trace_mod.Tracer:
        broker = self._broker
        return broker.tracer if broker is not None else \
            trace_mod.NULL_TRACER

    # -- enqueue ---------------------------------------------------------

    def request(self, indices: np.ndarray, wait_cm=None) -> int:
        """Ensure every index is cached, coalescing misses with other
        sessions. Returns the number of documents *charged* to this ask
        (misses it enqueued itself; joins of another session's pending
        ask are free). ``wait_cm``, if given, is a zero-arg context
        manager entered around any blocking wait (the session uses it to
        surface ORACLE_WAIT state).

        Failure isolation: a flush that raises fails only the waiters of
        that batch — each gets its *own* ``OracleUnavailable`` chained
        via ``__cause__`` (never a shared mutated traceback), and each
        waiter independently retries once first: bisection inside a
        resilient lane may have cached part of the batch, and a joiner
        should not die for a batch it merely coalesced into. The lane
        itself stays usable for the next ask either way."""
        charged = 0
        last_error: Optional[BaseException] = None
        with self._tracer.span("broker.request", kind="broker",
                               docs=len(indices)) as rspan:
            for round_ in range(2):
                need = self.cached.peek(indices)
                if not need:
                    if round_:
                        self.counters.inc("oracle_rejoin_recovered")
                    rspan.set(charged=charged)
                    return charged
                if round_:
                    self.counters.inc("oracle_waiter_retries")
                got, errors = self._one_round(need, wait_cm)
                charged += got
                if not errors:
                    rspan.set(charged=charged)
                    return charged
                last_error = errors[-1]
            rspan.set(charged=charged, failed=True)
        still = self.cached.peek(indices)
        if not still:
            return charged
        self.counters.inc("oracle_asks_failed")
        retry_after = max((getattr(e, "retry_after", 0.0)
                           for e in [last_error]), default=0.0)
        # the cause travels in the message too: sessions surface errors
        # as strings (over HTTP, in stats()), where __cause__ is lost
        raise OracleUnavailable(
            f"oracle lane failed for {len(still)} docs after retry "
            f"({type(last_error).__name__}: {last_error})",
            docs=still, retry_after=retry_after,
            breaker_open=getattr(last_error, "breaker_open", False),
        ) from last_error

    def _one_round(self, need, wait_cm):
        """Enqueue/join ``need``, settle, and report (charged, errors)
        instead of raising — ``request`` owns the retry/raise policy."""
        charged = 0
        waits: List[_Batch] = []
        to_flush: Optional[_Batch] = None
        # the enqueuing thread IS the session thread, so its ambient
        # span identifies the session tree this ask belongs to
        ctx = trace_mod.current_ctx()
        with self._lock:
            for doc in need:
                got = self._pending.get(doc)
                if got is not None:
                    if got not in waits:
                        waits.append(got)
                    continue
                if self._open is None:
                    self._open = _Batch(self.max_delay)
                self._open.docs.append(doc)
                self._pending[doc] = self._open
                charged += 1
                if self._open not in waits:
                    waits.append(self._open)
            # max_batch is a flush *trigger*, not a cap: one big ask
            # flushes as ONE oracle invocation (fragmenting it would
            # multiply round trips — the opposite of micro-batching);
            # small asks sit out the deadline so other sessions can join
            if ctx is not None:
                for batch in waits:
                    if (len(batch.contributors) < MAX_FLUSH_LINKS
                            and ctx not in batch.contributors):
                        batch.contributors.append(ctx)
            if (self._open is not None
                    and len(self._open.docs) >= self.max_batch):
                to_flush, self._open = self._open, None
        def settle():
            if to_flush is not None:
                self._flush(to_flush)
            outstanding = [b for b in waits if not b.event.is_set()]
            if outstanding:
                self._wait(outstanding)

        # both the inline flush (this thread pays the oracle round trip)
        # and waiting on someone else's flush are oracle time — surface
        # them to the session as ORACLE_WAIT
        if to_flush is not None or any(not b.event.is_set()
                                       for b in waits):
            if wait_cm is not None:
                with wait_cm():
                    settle()
            else:
                settle()
        return charged, [b.error for b in waits if b.error is not None]

    # -- flush machinery -------------------------------------------------

    def _wait(self, batches: List[_Batch]) -> None:
        for batch in batches:
            while not batch.event.is_set():
                timeout = max(batch.deadline - time.perf_counter(), 1e-3)
                if batch.event.wait(timeout):
                    break
                self._maybe_flush()

    def _maybe_flush(self) -> None:
        """Flush the open batch if its deadline has passed (called by
        waiters waking from a timed wait)."""
        to_flush = None
        with self._lock:
            if (self._open is not None
                    and time.perf_counter() >= self._open.deadline):
                to_flush, self._open = self._open, None
        if to_flush is not None:
            self._flush(to_flush)

    def flush_now(self) -> None:
        """Force the open batch out regardless of age (used on server
        drain so the last stragglers never wait out the deadline)."""
        with self._lock:
            to_flush, self._open = self._open, None
        if to_flush is not None:
            self._flush(to_flush)

    def _flush(self, batch: _Batch) -> None:
        t0 = time.perf_counter()
        # a coalesced flush serves many sessions at once, so its span is
        # a root of its own trace, *linked* to every contributor's span
        # rather than parented under whichever session happened to pay
        # the round trip
        fspan = self._tracer.span("oracle.flush", parent=None,
                                  kind="oracle", docs=len(batch.docs),
                                  sessions=len(batch.contributors))
        for ctx in batch.contributors:
            fspan.link(ctx)
        try:
            with fspan:
                # CachedOracle.label re-checks misses under its own
                # lock, so docs another path cached meanwhile are not
                # re-purchased
                self.cached.label(np.asarray(batch.docs, np.int64))
            self.counters.inc("oracle_flushes")
            self.counters.inc("oracle_docs_flushed", len(batch.docs))
            self.counters.observe("oracle_batch_occupancy",
                                  len(batch.docs))
            self.counters.observe("oracle_flush_seconds",
                                  time.perf_counter() - t0)
        except BaseException as exc:
            batch.error = exc
            self.counters.inc("oracle_batches_failed")
            self.counters.inc("oracle_docs_failed", len(batch.docs))
        finally:
            with self._lock:
                for doc in batch.docs:
                    if self._pending.get(doc) is batch:
                        del self._pending[doc]
            batch.event.set()


class SessionOracleHandle:
    """What a session's ``filter()`` call sees in place of the oracle.

    ``label()`` blocks until every asked document is cached (joining the
    lane's micro-batches on the way); ``calls`` counts the documents
    *this session* caused to be purchased, so per-session reports stay
    meaningful while the underlying oracle serves everyone at once.
    """

    def __init__(self, lane: _OracleLane, session=None):
        self._lane = lane
        self._session = session
        self.calls = 0

    @property
    def flops_per_doc(self) -> float:
        return self._lane.cached.flops_per_doc

    def peek(self, indices) -> List[int]:
        """Uncached (would-be-purchased) indices — read-only passthrough
        to the shared cache, used by provenance to split oracle-bought
        from cache-served labels before the buy happens."""
        return self._lane.cached.peek(indices)

    def label(self, indices) -> np.ndarray:
        indices = np.asarray(indices, np.int64)
        if len(indices):
            wait_cm = getattr(self._session, "oracle_wait", None)
            self.calls += self._lane.request(indices, wait_cm=wait_cm)
        # all present now: a pure cache read, never a purchase
        return self._lane.cached.label(indices)


class OracleBroker:
    """Shared micro-batching front for every oracle the server touches.

    One lane per ``CachedOracle``; ``wrap_for(session)`` returns the
    per-session ``oracle_wrap`` the engine's session view plugs in
    (handles are memoized per (session, oracle) so call accounting
    accumulates across a session's phases).
    """

    def __init__(self, *, max_batch: int = DEFAULT_MAX_BATCH,
                 max_delay: float = DEFAULT_MAX_DELAY,
                 counters: Optional[CounterSet] = None,
                 tracer: Optional[trace_mod.Tracer] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        self.max_delay = max_delay
        self.counters = counters if counters is not None else CounterSet()
        # settable after construction (the server attaches its tracer);
        # lanes resolve it per flush through their broker back-reference
        self.tracer = tracer if tracer is not None else \
            trace_mod.NULL_TRACER
        self._lock = threading.Lock()
        self._lanes: Dict[int, _OracleLane] = {}
        self._pins: List[CachedOracle] = []     # keep id()s stable

    def lane(self, cached: CachedOracle) -> _OracleLane:
        with self._lock:
            got = self._lanes.get(id(cached))
            if got is None or got.cached is not cached:
                got = _OracleLane(cached, self.max_batch, self.max_delay,
                                  self.counters, broker=self)
                self._lanes[id(cached)] = got
                self._pins.append(cached)
            return got

    def wrap_for(self, session=None) -> Callable:
        handles: Dict[int, SessionOracleHandle] = {}
        handle_lock = threading.Lock()

        def wrap(cached: CachedOracle) -> SessionOracleHandle:
            lane = self.lane(cached)
            with handle_lock:
                got = handles.get(id(cached))
                if got is None:
                    got = SessionOracleHandle(lane, session)
                    handles[id(cached)] = got
                return got
        return wrap

    def flush_all(self) -> None:
        with self._lock:
            lanes = list(self._lanes.values())
        for lane in lanes:
            lane.flush_now()
