"""PredicateServer: concurrent query sessions over one resident engine
(a copy of ``repro.serve.server``).

The engine's ``filter()`` is a blocking single-caller API; production
traffic is many ad-hoc predicates arriving at once. The server owns one
resident ``ScaleDocEngine`` (hence one store, one executor, one set of
cross-query label caches) and executes sessions on a worker pool behind
a bounded admission queue:

    submit() ──► admission queue ──► worker pool ──► session.result()
                 (backpressure:       each worker runs
                  ServerSaturated     filter() on an isolated
                  when full)          engine session view

Each session progresses through explicit states — QUEUED → TRAINING →
SCORING → ORACLE_WAIT → DONE (FAILED on error) — streams partial
results (accepted/rejected doc-id deltas after every resolved leaf) and
keeps per-session stats. All oracle label traffic routes through the
shared ``OracleBroker``, which coalesces asks across in-flight sessions
into micro-batches over the engine's ``CachedOracle``s.

Bit-parity: session views isolate the proxy/decision caches, so every
session computes exactly what a serial ``filter()`` on a fresh engine
(sharing the label caches) would — concurrency changes throughput and
oracle invocation shape, never decisions.

Standing predicates over live collections (``live=``, ``enable_live``,
``subscribe``) run on a ``repro_torch.engine.live.LiveEngine`` over the
resident engine: each subscription is a ``StandingSession`` sharing the
query sessions' id namespace. The server runs on the device of the
engine it is given.
"""
from __future__ import annotations

import contextlib
import enum
import queue
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.engine.engine import FilterResult, ScaleDocEngine
from repro_torch.engine.live import (DeltaBatch, DriftConfig, LiveEngine,
                                     StandingPredicate, Subscription)
from repro_torch.engine.optimizer import QueryOptimizer
from repro_torch.engine.predicate import Predicate
from repro_torch.runtime import trace as trace_mod
from repro_torch.runtime.metrics import CounterSet
from repro_torch.serve.broker import OracleBroker


class ServerSaturated(RuntimeError):
    """Admission queue full: shed load upstream or raise queue_depth."""


class ServerClosed(RuntimeError):
    """submit() after shutdown()."""


class SessionCancelled(RuntimeError):
    """Session aborted by ``QuerySession.cancel()`` (e.g. a gateway
    DELETE): raised to consumers blocked on result()/iter_deltas()."""


class SessionState(enum.Enum):
    QUEUED = "queued"
    TRAINING = "training"
    SCORING = "scoring"
    ORACLE_WAIT = "oracle_wait"
    DONE = "done"
    FAILED = "failed"
    CANCELLED = "cancelled"


_TERMINAL = (SessionState.DONE, SessionState.FAILED,
             SessionState.CANCELLED)


# engine filter() phases -> session states (planning is a scoring pass)
_PHASE_STATES = {
    "planning": SessionState.SCORING,
    "training": SessionState.TRAINING,
    "scoring": SessionState.SCORING,
}


@dataclass
class QueryRequest:
    predicate: Predicate
    accuracy_target: Optional[float] = None
    ground_truth: Optional[np.ndarray] = None
    seed: int = 0
    name: Optional[str] = None
    tenant: Optional[str] = None    # admission identity (set by gateways)
    # caller-propagated trace context (e.g. a gateway request span): the
    # session's root span parents onto it, so one trace id follows the
    # query from the HTTP edge through engine, broker and oracle
    trace_ctx: Optional[trace_mod.SpanContext] = None


@dataclass
class Delta:
    """One streamed increment of decided documents."""
    accepted: np.ndarray
    rejected: np.ndarray
    seq: int = 0
    final: bool = False


class QuerySession:
    """Handle for one in-flight (or finished) query.

    Doubles as the engine-side observer: ``on_phase``/``on_partial``
    are invoked by the session's engine view, ``oracle_wait`` by its
    broker handles. Consumers use ``state``, ``iter_deltas()``,
    ``result()`` and ``stats()``.
    """

    def __init__(self, request: QueryRequest, counters: CounterSet):
        self.id = uuid.uuid4().hex[:12]
        self.request = request
        self.name = request.name or f"session-{self.id[:6]}"
        self.tenant = request.tenant
        # trace id of this session's root span (set by the worker when
        # tracing is on; echoed through stats() so clients can fetch
        # /v1/traces?trace_id=... for their own query)
        self.trace_id: Optional[str] = None
        self._counters = counters
        self._cancel = False
        self._cond = threading.Condition()
        self._state = SessionState.QUEUED
        self._history: List[tuple] = [(SessionState.QUEUED.value,
                                       time.perf_counter())]
        self._deltas: List[Delta] = []
        self._result: Optional[FilterResult] = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()
        self._accepted = 0
        self._rejected = 0
        self._oracle_wait_seconds = 0.0
        self._submitted_at = time.perf_counter()
        self._started_at: Optional[float] = None
        self._finished_at: Optional[float] = None

    # -- engine-facing observer hooks ------------------------------------

    def on_phase(self, phase: str) -> None:
        self._check_cancelled()
        state = _PHASE_STATES.get(phase)
        if state is not None:
            self._set_state(state)

    def on_partial(self, accepted: np.ndarray, rejected: np.ndarray) -> None:
        self._check_cancelled()
        with self._cond:
            self._deltas.append(Delta(accepted=np.asarray(accepted),
                                      rejected=np.asarray(rejected),
                                      seq=len(self._deltas)))
            self._accepted += len(accepted)
            self._rejected += len(rejected)
            self._cond.notify_all()

    @contextlib.contextmanager
    def oracle_wait(self):
        self._check_cancelled()
        prev = self.state
        self._set_state(SessionState.ORACLE_WAIT)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._oracle_wait_seconds += time.perf_counter() - t0
            self._set_state(prev)

    # -- server-facing lifecycle -----------------------------------------

    def _mark_started(self) -> None:
        self._started_at = time.perf_counter()
        self._counters.observe("session_queue_wait_seconds",
                               self._started_at - self._submitted_at)

    def _finish(self, result: FilterResult) -> None:
        self._result = result
        self._finished_at = time.perf_counter()
        with self._cond:
            self._deltas.append(Delta(accepted=np.array([], np.int64),
                                      rejected=np.array([], np.int64),
                                      seq=len(self._deltas), final=True))
            self._cond.notify_all()
        self._set_state(SessionState.DONE)
        self._done.set()

    def _fail(self, error: BaseException) -> None:
        if self._done.is_set():       # cancel/fail races are first-wins
            return
        self._error = error
        self._finished_at = time.perf_counter()
        self._set_state(SessionState.CANCELLED
                        if isinstance(error, SessionCancelled)
                        else SessionState.FAILED)
        with self._cond:
            self._cond.notify_all()
        self._done.set()

    def _set_state(self, state: SessionState) -> None:
        with self._cond:
            if self._state in _TERMINAL:
                return
            self._state = state
            self._history.append((state.value, time.perf_counter()))

    def _check_cancelled(self) -> None:
        if self._cancel:
            raise SessionCancelled(f"{self.name} cancelled")

    # -- consumer API -----------------------------------------------------

    @property
    def state(self) -> SessionState:
        with self._cond:
            return self._state

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> bool:
        """Request cancellation. Cooperative: a QUEUED session is failed
        immediately (workers skip it); a running one aborts at its next
        observer callback (phase change, leaf delta, oracle wait).
        Returns False if the session had already finished."""
        with self._cond:
            if self._state in _TERMINAL:
                return False
            self._cancel = True
            queued = self._state is SessionState.QUEUED
        if queued:
            self._fail(SessionCancelled(f"{self.name} cancelled while "
                                        "queued"))
        return True

    def result(self, timeout: Optional[float] = None) -> FilterResult:
        if not self._done.wait(timeout):
            raise TimeoutError(f"{self.name} still {self.state.value} "
                               f"after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def get_delta(self, seq: int, timeout: Optional[float] = None
                  ) -> Optional[Delta]:
        """Delta number ``seq``, or None if it hasn't arrived within
        ``timeout`` — the resumable primitive under ``iter_deltas``.
        The gateway polls this so an idle wait can emit an SSE
        keep-alive and *continue*, which a generator that raised
        TimeoutError could not."""
        with self._cond:
            while seq >= len(self._deltas):
                if self._error is not None:
                    raise self._error
                if not self._cond.wait(timeout):
                    return None
            return self._deltas[seq]

    def iter_deltas(self, timeout: Optional[float] = None):
        """Yield accepted/rejected doc-id deltas as leaves resolve,
        until the final (empty, ``final=True``) delta. Safe to call
        while the session is still running."""
        seen = 0
        while True:
            delta = self.get_delta(seen, timeout)
            if delta is None:
                raise TimeoutError(
                    f"{self.name}: no delta within {timeout}s")
            seen += 1
            yield delta
            if delta.final:
                return

    def stats(self) -> Dict:
        with self._cond:
            history = list(self._history)
            accepted, rejected = self._accepted, self._rejected
        wall = ((self._finished_at or time.perf_counter())
                - self._submitted_at)
        run = (None if self._started_at is None else
               (self._finished_at or time.perf_counter())
               - self._started_at)
        return {
            "id": self.id, "name": self.name, "tenant": self.tenant,
            "trace_id": self.trace_id,
            "state": self.state.value,
            "states": history,
            "accepted": accepted, "rejected": rejected,
            "oracle_wait_seconds": self._oracle_wait_seconds,
            "queue_wait_seconds": (None if self._started_at is None else
                                   self._started_at - self._submitted_at),
            "run_seconds": run,
            "wall_seconds": wall,
        }


class StandingState(enum.Enum):
    LIVE = "live"
    CANCELLED = "cancelled"


class StandingSession:
    """Session-shaped handle over one standing-predicate subscription.

    Mirrors enough of ``QuerySession``'s consumer surface — ``id``,
    ``name``, ``tenant``, ``state``, ``done()``, ``cancel()``,
    ``iter_deltas()``, ``stats()`` — that the gateway's session
    plumbing (lookup, SSE streaming, DELETE cancel, per-tenant
    in-flight accounting) works on it unchanged. Unlike a query
    session it never finishes on its own: batches flow per processed
    commit group until ``cancel()`` (or server shutdown) pushes the
    final sentinel."""

    def __init__(self, standing: StandingPredicate,
                 subscription: Subscription,
                 tenant: Optional[str] = None):
        self.id = standing.id
        self.standing = standing
        self.subscription = subscription
        self.name = standing.name
        self.tenant = tenant
        self._submitted_at = time.perf_counter()

    @property
    def state(self) -> StandingState:
        return (StandingState.CANCELLED if self.standing.done()
                else StandingState.LIVE)

    def done(self) -> bool:
        """True once cancelled — the signal TenantState.in_flight uses
        to lazily free this session's concurrency slot."""
        return self.standing.done()

    def cancel(self) -> bool:
        return self.standing.cancel()

    def result(self, timeout: Optional[float] = None):
        raise TypeError(
            f"standing session {self.name!r} has no final result; "
            "consume iter_deltas() or read standing.decisions")

    def iter_deltas(self, timeout: Optional[float] = None):
        """Yield ``DeltaBatch``es as commit groups are processed, until
        the final sentinel after cancel/shutdown. ``timeout`` bounds
        the wait for each next batch (TimeoutError past it)."""
        while True:
            batch: DeltaBatch = self.subscription.get(timeout=timeout)
            yield batch
            if batch.final:
                return

    def stats(self) -> Dict:
        snap = self.standing.stats()
        snap["tenant"] = self.tenant
        snap["standing"] = True
        snap["wall_seconds"] = time.perf_counter() - self._submitted_at
        return snap


_STOP = object()


class PredicateServer:
    """Thread-pool predicate-serving front over one resident engine."""

    def __init__(self, engine: ScaleDocEngine, *, workers: int = 4,
                 queue_depth: int = 32,
                 broker: Optional[OracleBroker] = None,
                 max_batch: int = 16, max_delay: float = 0.002,
                 counters: Optional[CounterSet] = None,
                 keep_sessions: int = 1024,
                 live: Optional[LiveEngine] = None,
                 degrade: Optional[str] = None,
                 optimize: bool = False,
                 optimizer: Optional[QueryOptimizer] = None,
                 trace: bool = True,
                 trace_capacity: int = 4096,
                 tracer: Optional[trace_mod.Tracer] = None,
                 ledger: Optional[trace_mod.CostLedger] = None):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if degrade is not None and degrade not in ("fail", "defer",
                                                   "proxy_fallback"):
            raise ValueError(f"unknown degrade policy {degrade!r}")
        self.engine = engine
        # oracle-outage policy applied to every session's filter():
        # "fail" surfaces OracleUnavailable to result(); "defer" finishes
        # sessions degraded with a repair queue (drain_repairs());
        # "proxy_fallback" decides by proxy score, flagged. None
        # inherits whatever policy the engine was built with.
        self.degrade = engine.degrade if degrade is None else degrade
        # standing-predicate support: a LiveEngine over the same resident
        # engine (pass one in, or call enable_live()); None = subscribe()
        # is refused
        self.live = live
        # cross-query optimizer: shared-leaf CSE + cross-session
        # selectivity stats (repro.engine.optimizer). Off by default —
        # sessions then evaluate every leaf themselves, the pre-PR-9
        # behavior. Decisions are identical either way (every shared
        # value is a pure function of its key); only cost changes.
        self.optimizer = optimizer or (QueryOptimizer() if optimize
                                       else None)
        self.counters = counters if counters is not None else CounterSet()
        # observability plane: one tracer (bounded flight-recorder ring)
        # and one cost ledger for the whole server. trace=False swaps in
        # a disabled tracer whose spans are a shared no-op singleton —
        # near-zero overhead and bitwise-identical decisions either way.
        self.tracer = (tracer if tracer is not None
                       else trace_mod.Tracer(enabled=trace,
                                             capacity=trace_capacity))
        self.ledger = ledger or trace_mod.CostLedger()
        self._waste_seen = 0            # retry-waste already ledgered
        self.broker = broker or OracleBroker(max_batch=max_batch,
                                             max_delay=max_delay,
                                             counters=self.counters)
        self.broker.tracer = self.tracer
        # repair replays run on the engine itself (not a session view)
        self.engine._tracer = self.tracer
        if live is not None:
            live.tracer = self.tracer
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._closed = False
        self._lock = threading.Lock()
        # bounded history for sessions(): a long-lived server would
        # otherwise pin every finished session's result arrays forever
        self._sessions: "deque[QuerySession]" = deque(maxlen=keep_sessions)
        self._standing: "deque[StandingSession]" = deque(
            maxlen=keep_sessions)
        self._workers = [threading.Thread(target=self._worker_loop,
                                          name=f"scaledoc-serve-{i}",
                                          daemon=True)
                         for i in range(workers)]
        for t in self._workers:
            t.start()

    # -- submission -------------------------------------------------------

    def submit(self, predicate: Predicate, *,
               accuracy_target: Optional[float] = None,
               ground_truth: Optional[np.ndarray] = None,
               seed: int = 0, name: Optional[str] = None,
               tenant: Optional[str] = None,
               block: bool = False,
               timeout: Optional[float] = None,
               trace_ctx: Optional[trace_mod.SpanContext] = None
               ) -> QuerySession:
        """Admit one query. Non-blocking by default: raises
        ``ServerSaturated`` when the admission queue is full (callers
        shed or retry); ``block=True`` waits up to ``timeout``.
        ``tenant`` tags the session with its admission identity (the
        gateway's per-tenant accounting reads it back from stats);
        ``trace_ctx`` parents the session's root span on the caller's
        span (e.g. the gateway's per-request span)."""
        request = QueryRequest(predicate=predicate,
                               accuracy_target=accuracy_target,
                               ground_truth=ground_truth, seed=seed,
                               name=name, tenant=tenant,
                               trace_ctx=trace_ctx)
        session = QuerySession(request, self.counters)
        # the session's trace id is fixed at admission (inherited from
        # the caller's context or minted fresh), not when a worker picks
        # the session up — so the submit response can already carry it
        if self.tracer.enabled:
            session.trace_id = (trace_ctx.trace_id if trace_ctx is not None
                                else trace_mod._new_trace_id())
        # closed-check and enqueue are one atomic step (shutdown takes
        # the same lock), so a session can never slip in behind the
        # worker stop sentinels and hang unserved. Workers never take
        # this lock, so a blocking put still drains.
        with self._lock:
            if self._closed:
                raise ServerClosed("server is shut down")
            # gauge moves before the put: a worker may dequeue (and
            # decrement) the instant the session lands
            self.counters.gauge_delta("queue_depth", 1)
            try:
                self._queue.put(session, block=block, timeout=timeout)
            except queue.Full:
                self.counters.gauge_delta("queue_depth", -1)
                self.counters.inc("sessions_rejected")
                raise ServerSaturated(
                    f"admission queue full ({self._queue.maxsize} deep); "
                    "retry later or raise queue_depth") from None
            self._sessions.append(session)
        self.counters.inc("sessions_submitted")
        return session

    # -- standing predicates (live collections) ---------------------------

    def enable_live(self, *, drift: Optional[DriftConfig] = None
                    ) -> LiveEngine:
        """Build (or return) the server's ``LiveEngine`` over the
        resident engine. Callers pump it after ingest commit groups;
        ``subscribe()`` registers standing predicates against it."""
        with self._lock:
            if self.live is None:
                self.live = LiveEngine(self.engine, drift=drift)
                self.live.tracer = self.tracer
            return self.live

    def subscribe(self, predicate: Predicate, *,
                  seed: int = 0, name: Optional[str] = None,
                  accuracy_target: Optional[float] = None,
                  tenant: Optional[str] = None,
                  drift: Optional[DriftConfig] = None) -> StandingSession:
        """Register a standing predicate and subscribe to its per-commit-
        group accept/reject deltas. Registration (the calibration
        ``filter()`` over the committed prefix) runs synchronously on
        the calling thread — it is ordinary query work; the *deltas*
        are what stream. Returns a session whose ``iter_deltas()``
        yields ``repro_torch.engine.live.DeltaBatch``es until
        cancelled."""
        with self._lock:
            if self._closed:
                raise ServerClosed("server is shut down")
            live = self.live
        if live is None:
            raise RuntimeError(
                "standing predicates are disabled: construct the server "
                "with live=LiveEngine(...) or call enable_live() first")
        standing = live.register(predicate, seed=seed, name=name,
                                 accuracy_target=accuracy_target,
                                 drift=drift)
        session = StandingSession(standing, standing.subscribe(),
                                  tenant=tenant)
        with self._lock:
            self._standing.append(session)
        self.counters.inc("standing_subscribed")
        return session

    def standing_sessions(self) -> List[StandingSession]:
        with self._lock:
            return list(self._standing)

    def run(self, predicates: Sequence, *, seeds: Optional[Sequence[int]]
            = None, accuracy_target: Optional[float] = None,
            timeout: Optional[float] = None) -> List[FilterResult]:
        """Convenience: submit a batch (blocking admission) and wait for
        every result, in submission order."""
        seeds = seeds if seeds is not None else range(len(predicates))
        sessions = [self.submit(p, seed=s, block=True,
                                accuracy_target=accuracy_target)
                    for p, s in zip(predicates, seeds)]
        return [s.result(timeout) for s in sessions]

    # -- workers ----------------------------------------------------------

    def _worker_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is _STOP:
                return
            session: QuerySession = item
            self.counters.gauge_delta("queue_depth", -1)
            if session.done():      # cancelled while queued: skip
                self.counters.inc("sessions_cancelled")
                continue
            self.counters.gauge_delta("active_sessions", 1)
            session._mark_started()
            view = self.engine.session_view(
                oracle_wrap=self.broker.wrap_for(session),
                observer=session, optimizer=self.optimizer,
                tracer=self.tracer)
            req = session.request
            # the session's root span: everything the engine/broker emit
            # for this query nests under it; parented on the caller's
            # propagated context (gateway request span) when present
            sspan = self.tracer.span(
                "session", parent=req.trace_ctx,
                trace_id=session.trace_id, kind="server",
                session=session.id, tenant=req.tenant or "public",
                query=session.name, seed=req.seed)
            if sspan.ctx is not None:
                session.trace_id = sspan.ctx.trace_id
            try:
                with sspan:
                    result = view.filter(
                        req.predicate,
                        accuracy_target=req.accuracy_target,
                        ground_truth=req.ground_truth, seed=req.seed,
                        degrade=self.degrade, name=session.name)
                    sspan.set(accepted=int(np.sum(result.mask)),
                              oracle_calls=result.oracle_calls_total,
                              degraded=result.degraded)
                session._finish(result)
                self._record_ledger(session, result)
                self.counters.inc("sessions_done")
                if result.degraded:
                    self.counters.inc("sessions_degraded")
                    self.counters.inc("docs_deferred",
                                      len(result.unresolved))
                    self.counters.inc("docs_fallback",
                                      result.fallback_docs)
                self.counters.observe(
                    "session_latency_seconds",
                    session._finished_at - session._submitted_at)
                self.counters.observe("session_oracle_wait_seconds",
                                      session._oracle_wait_seconds)
            except BaseException as exc:
                session._fail(exc)
                self.counters.inc("sessions_cancelled"
                                  if isinstance(exc, SessionCancelled)
                                  else "sessions_failed")
            finally:
                self.counters.gauge_delta("active_sessions", -1)

    # -- cost attribution --------------------------------------------------

    def _record_ledger(self, session: QuerySession,
                       result: FilterResult) -> None:
        """One finished session -> cost-ledger rows, per leaf. Oracle-doc
        columns are the broker's per-session charge counts (LeafReport
        train/calib/online), so per-tenant totals reconcile against the
        broker's purchase counters fault-free. Proxy FLOPs estimate the
        full-collection scoring pass; a CSE-reused leaf pays neither and
        is credited the training labels it would have bought alone."""
        n = result.n_docs
        n_train = min(max(int(self.engine.proxy_cfg.train_fraction * n),
                          16), n)
        rows = []
        for rep in result.leaf_reports:
            reused = bool(rep.proxy_reused)
            # charged = calib + online the session actually paid (handle-
            # calls delta, cache hits/joins free); split it with calib
            # first so the columns sum to the exact charge
            charged = int(rep.oracle_docs_charged)
            calib = min(int(rep.oracle_calls_calib), charged)
            rows.append({
                "leaf": rep.name,
                "oracle_docs_train": int(rep.oracle_calls_train),
                "oracle_docs_calib": calib,
                "oracle_docs_online": charged - calib,
                "proxy_flops": (0.0 if reused
                                else n * self.ledger.proxy_flops_per_doc),
                "reused": reused,
                "cse_saved_docs": n_train if reused else 0,
            })
        self.ledger.record_session(
            session_id=session.id, tenant=session.tenant,
            name=session.name, trace_id=session.trace_id,
            leaves=rows, wall_seconds=result.wall_seconds,
            degraded=result.degraded)

    # -- degraded-mode operations ------------------------------------------

    def drain_repairs(self, *, block: bool = False,
                      timeout: Optional[float] = None
                      ) -> List[QuerySession]:
        """Resubmit every ticket the engine parked under
        ``degrade="defer"`` as a normal session (fresh view, same seed —
        the post-heal replay is bitwise the fault-free run). A replay
        that degrades again re-parks itself, so draining while the
        oracle is still down converges to the same queue. Wire this to
        a ``ResilientOracle(on_half_open=...)`` callback to re-drain
        the moment a breaker lets a probe through."""
        out: List[QuerySession] = []
        tickets = self.engine.take_repairs()
        for i, ticket in enumerate(tickets):
            try:
                out.append(self.submit(
                    ticket.predicate,
                    accuracy_target=ticket.accuracy_target,
                    ground_truth=ticket.ground_truth, seed=ticket.seed,
                    name=ticket.name, block=block, timeout=timeout))
            except (ServerSaturated, ServerClosed):
                # take_repairs() popped every ticket: repark the one
                # that failed admission AND all still-unsubmitted ones,
                # or the defer contract's replay promise is broken
                for unsubmitted in tickets[i:]:
                    self.engine.repark(unsubmitted)
                break
        if out:
            self.counters.inc("repairs_drained", len(out))
        return out

    def oracle_health(self) -> Dict:
        """Aggregate circuit-breaker state across the engine's oracle
        lanes: worst state wins (open > half_open > closed), plus the
        longest advisory retry-after. Lanes without a resilience layer
        count as closed."""
        with self.engine._lock:
            oracles = list(self.engine._oracles.values())
        rank = {"closed": 0, "half_open": 1, "open": 2}
        worst, retry_after, lanes = "closed", 0.0, 0
        for o in oracles:
            breaker = getattr(o, "breaker", None)
            if breaker is None:
                continue
            lanes += 1
            state = breaker.status()["state"]
            if rank[state] > rank[worst]:
                worst = state
            retry_after = max(retry_after, breaker.retry_after())
        return {"state": worst, "retry_after": retry_after,
                "breaker_lanes": lanes,
                "repair_queue": self.engine.repair_count}

    # -- introspection -----------------------------------------------------

    def sessions(self) -> List[QuerySession]:
        with self._lock:
            return list(self._sessions)

    def get_session(self, session_id: str) -> Optional[QuerySession]:
        """Look up a (live or recently finished) session by id — the
        handle a network front end round-trips to its clients. Query
        and standing sessions share one id namespace."""
        with self._lock:
            for session in self._sessions:
                if session.id == session_id:
                    return session
            for standing in self._standing:
                if standing.id == session_id:
                    return standing
        return None

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def explain(self, session_id: str, *,
                include_docs: bool = True) -> Dict:
        """Decision provenance for one finished query session: which
        mechanism (proxy threshold / oracle / cached label / fallback /
        ...) decided every document, and at which leaf. The body behind
        ``GET /v1/queries/<id>/explain``. ``include_docs=False`` drops
        the O(N) per-doc arrays and keeps the counts/legend."""
        session = self.get_session(session_id)
        if session is None:
            raise KeyError(f"unknown session {session_id!r}")
        if isinstance(session, StandingSession):
            raise TypeError(
                f"standing session {session_id!r} has no provenance map "
                "(decisions stream incrementally; read standing stats)")
        if not session.done():
            raise RuntimeError(f"session {session_id} still "
                               f"{session.state.value}; provenance is "
                               "assembled when filter() finishes")
        result = session.result(timeout=0)   # raises the stored error
        payload = {"session": session.id, "name": session.name,
                   "tenant": session.tenant,
                   "trace_id": session.trace_id,
                   "plan": result.plan, "degraded": result.degraded}
        if result.provenance is not None:
            payload.update(result.provenance.to_payload(
                mask=result.mask, include_docs=include_docs))
        else:                                # pre-provenance result shape
            payload.update({"n_docs": result.n_docs, "counts": {},
                            "complete": False})
        return payload

    def trace_snapshot(self, *, trace_id: Optional[str] = None,
                       limit: Optional[int] = None,
                       chrome: bool = False) -> Dict:
        """Flight-recorder contents (the ``/v1/traces`` body): recent
        spans, optionally filtered to one trace id, newest last.
        ``chrome=True`` returns Chrome-trace/Perfetto JSON instead."""
        if chrome:
            return self.tracer.chrome_trace(trace_id)
        return self.tracer.snapshot(trace_id, limit)

    def metrics_snapshot(self) -> Dict:
        """JSON-serializable view of the server's counters plus oracle
        cache totals (docs purchased / served from cache)."""
        snap = self.counters.snapshot()
        with self.engine._lock:
            oracles = list(self.engine._oracles.values())
        snap["oracle_cache"] = {
            "oracles": len(oracles),
            "docs_purchased": sum(o.calls for o in oracles),
            "docs_cached": sum(o.cached_count for o in oracles),
            "purchases": sum(o.purchases for o in oracles),
            "cache_hits": sum(o.hits for o in oracles),
        }
        snap["queue"] = {"depth": self._queue.qsize(),
                         "capacity": self._queue.maxsize}
        # resilience: per-lane retry/breaker counters (lanes wrapped in
        # a ResilientOracle) plus the aggregate health the gateway maps
        # to /readyz and 503 + Retry-After
        lanes = [o.resilience_stats() for o in oracles
                 if hasattr(o, "resilience_stats")]
        snap["resilience"] = {
            "degrade": self.degrade,
            "lanes": lanes,
            "health": self.oracle_health(),
        }
        snap["optimizer"] = (self.optimizer.snapshot()
                             if self.optimizer is not None
                             else {"enabled": False})
        # retry waste is lane-level (a retried flush serves every waiter
        # at once, so no single tenant owns it): sync the docs burned by
        # gave-up batches into the ledger's `_infra` pseudo-tenant,
        # delta'd so repeated snapshots never double-count
        waste = sum(l.get("gave_up_docs", 0) for l in lanes)
        retries = sum(l.get("retries", 0) for l in lanes)
        with self._lock:
            d_waste, self._waste_seen = waste - self._waste_seen, waste
        if d_waste > 0:
            self.ledger.record_retry_waste(docs=d_waste, retries=retries)
        snap["cost_ledger"] = self.ledger.snapshot()
        snap["trace"] = {k: v
                         for k, v in self.tracer.snapshot(limit=1).items()
                         if k != "spans"}
        with self._lock:
            standing = list(self._standing)
        snap["standing"] = {
            "subscribed": len(standing),
            "live": sum(1 for s in standing if not s.done()),
            "watermark": (len(self.live.store)
                          if self.live is not None else 0),
        }
        return snap

    def metrics_json(self, indent: int = 2) -> str:
        import json
        return json.dumps(self.metrics_snapshot(), indent=indent,
                          sort_keys=True, default=float)

    # -- lifecycle ---------------------------------------------------------

    def shutdown(self, wait: bool = True) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for _ in self._workers:
            self._queue.put(_STOP)
        # cancel standing subscriptions so their delta streams terminate
        # (the final sentinel flows to every subscriber)
        for standing in self.standing_sessions():
            standing.cancel()
        if wait:
            for t in self._workers:
                t.join()
        self.broker.flush_all()

    def __enter__(self) -> "PredicateServer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(wait=True)
