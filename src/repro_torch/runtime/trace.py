"""Tracing, decision provenance and cost attribution: the
observability plane (a copy of ``repro.runtime.trace``, stdlib + numpy).

* ``Tracer``: nested spans with monotonic-clock timings, recorded into
  a bounded in-memory ring (the "flight recorder") and exportable as
  Chrome-trace / Perfetto JSON. Spans parent implicitly through a
  thread-local ambient stack (``with tracer.span("train"): ...``) or
  explicitly across threads/processes via ``SpanContext``.
* ``traceparent`` propagation: ``make_traceparent`` /
  ``parse_traceparent`` carry a (trace_id, span_id) pair in the W3C
  header shape, so a caller's request, the server session it admits,
  and every engine/broker span under it share one rooted tree.
* ambient annotation: ``annotate()`` / ``add_event()`` attach data to
  whatever span is current *without holding a tracer reference*; this
  is how deep layers (``ResilientOracle`` retries, executor passes,
  the optimizer's single-flight claims) report into the session's tree.
* ``ProvenanceMap``: the per-document decision provenance a
  ``filter()`` call emits: for every doc, which class of mechanism
  decided it (proxy threshold, oracle purchase, cached label, top-k
  skip, degraded fallback, ...) and at which leaf. The codes and class
  names are the JAX package's, so a map from either package reads the
  same.
* ``CostLedger``: per-(tenant, session, leaf) attribution of oracle
  docs purchased, proxy FLOP estimates, CSE savings credited to
  reusers, and retry waste.

Disabled-path contract: a ``Tracer(enabled=False)`` (or the shared
``NULL_TRACER``) returns one preallocated no-op span from every
``span()`` call (no allocation, no clock read, no lock), so tracing
gates to near-zero overhead when off, and tracing on/off can never
change decisions (nothing here touches an RNG stream or an oracle).
"""
from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "SpanContext", "Span", "Tracer", "NULL_TRACER",
    "make_traceparent", "parse_traceparent",
    "current_span", "current_ctx", "annotate", "add_event",
    "span_tree", "format_span_tree",
    "PROVENANCE_CLASSES", "PROXY_ACCEPT", "PROXY_REJECT", "ORACLE",
    "CACHED_LABEL", "TOPK_SKIP", "PROXY_FALLBACK", "SHORT_CIRCUIT",
    "UNRESOLVED", "UNCLASSIFIED", "ProvenanceMap", "CostLedger",
]


# --------------------------------------------------------------------------
# span context + traceparent propagation
# --------------------------------------------------------------------------

class SpanContext(Tuple[str, str]):
    """(trace_id, span_id) — the portable identity of one span."""

    __slots__ = ()

    def __new__(cls, trace_id: str, span_id: str):
        return tuple.__new__(cls, (trace_id, span_id))

    @property
    def trace_id(self) -> str:
        return self[0]

    @property
    def span_id(self) -> str:
        return self[1]


def _new_trace_id() -> str:
    return uuid.uuid4().hex                   # 32 hex chars

def _new_span_id() -> str:
    return uuid.uuid4().hex[:16]              # 16 hex chars


def make_traceparent(ctx: SpanContext) -> str:
    """W3C-shaped header value: ``00-<trace_id>-<span_id>-01``."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def parse_traceparent(value: Optional[str]) -> Optional[SpanContext]:
    """Parse a ``traceparent`` header; None on anything malformed (a
    bad header must degrade to "start a fresh trace", never to a 500).
    """
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, _flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id)


# --------------------------------------------------------------------------
# ambient (thread-local) span stack
# --------------------------------------------------------------------------

_ambient = threading.local()


def _stack() -> list:
    stack = getattr(_ambient, "stack", None)
    if stack is None:
        stack = _ambient.stack = []
    return stack


def current_span() -> Optional["Span"]:
    stack = getattr(_ambient, "stack", None)
    return stack[-1] if stack else None


def current_ctx() -> Optional[SpanContext]:
    span = current_span()
    return span.ctx if span is not None else None


def annotate(**attrs) -> None:
    """Set attributes on the current ambient span (no-op without one).
    Deep layers use this instead of threading a tracer reference."""
    span = current_span()
    if span is not None:
        span.set(**attrs)


def add_event(name: str, **attrs) -> None:
    """Record a point-in-time event on the current ambient span."""
    span = current_span()
    if span is not None:
        span.event(name, **attrs)


# --------------------------------------------------------------------------
# spans
# --------------------------------------------------------------------------

class Span:
    """One timed operation. Context-manager use pushes it onto the
    thread's ambient stack so nested spans parent automatically and
    ``annotate``/``add_event`` reach it from any call depth."""

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "start", "end_time", "attrs", "events", "links",
                 "thread", "_ended", "_pushed")

    def __init__(self, tracer: "Tracer", name: str,
                 parent: Optional[SpanContext], trace_id: Optional[str],
                 attrs: Dict):
        self.tracer = tracer
        self.name = name
        if parent is not None:
            self.trace_id = parent.trace_id
            self.parent_id = parent.span_id
        else:
            self.trace_id = trace_id or _new_trace_id()
            self.parent_id = None
        self.span_id = _new_span_id()
        self.start = time.perf_counter()
        self.end_time: Optional[float] = None
        self.attrs = attrs
        self.events: List[Dict] = []
        self.links: List[SpanContext] = []
        self.thread = threading.current_thread().name
        self._ended = False
        self._pushed = False

    @property
    def ctx(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs) -> "Span":
        self.events.append({"t": time.perf_counter(), "name": name,
                            "attrs": attrs})
        return self

    def link(self, ctx: Optional[SpanContext]) -> "Span":
        """Associate another span (e.g. a broker flush linking every
        contributing session's span) without parenting it."""
        if ctx is not None:
            self.links.append(ctx)
        return self

    def end(self) -> None:
        if self._ended:
            return
        self._ended = True
        self.end_time = time.perf_counter()
        self.tracer._record(self)

    # -- context manager --------------------------------------------------

    def __enter__(self) -> "Span":
        _stack().append(self)
        self._pushed = True
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._pushed:
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:          # defensive: unbalanced exits
                stack.remove(self)
            self._pushed = False
        if exc is not None:
            self.attrs.setdefault("error", f"{type(exc).__name__}: {exc}")
        self.end()

    def to_dict(self) -> Dict:
        end = self.end_time if self.end_time is not None else self.start
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start": self.start, "end": end,
                "duration": end - self.start, "thread": self.thread,
                "attrs": dict(self.attrs),
                "events": [dict(e) for e in self.events],
                "links": [{"trace_id": c.trace_id, "span_id": c.span_id}
                          for c in self.links]}


class _NoopSpan:
    """The disabled-path span: every method is a no-op returning self,
    ``ctx`` is None (callers propagate nothing), and it never touches
    the ambient stack, the clock, or a lock."""

    __slots__ = ()
    ctx = None
    trace_id = None
    span_id = None

    def set(self, **attrs):
        return self

    def event(self, name: str, **attrs):
        return self

    def link(self, ctx):
        return self

    def end(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


NOOP_SPAN = _NoopSpan()

_AMBIENT = object()     # sentinel: "parent = whatever span is current"


# --------------------------------------------------------------------------
# tracer + flight recorder
# --------------------------------------------------------------------------

class Tracer:
    """Span factory + bounded flight recorder.

    ``capacity`` bounds the number of *finished* spans retained (ring
    semantics: the oldest are dropped, ``dropped`` counts them), so a
    long-lived server records forever in O(capacity) memory; a compound
    query over the serving stack emits roughly 10–25 spans.
    """

    def __init__(self, enabled: bool = True, capacity: int = 4096):
        self.enabled = enabled
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: "deque[Dict]" = deque(maxlen=self.capacity)
        self._recorded = 0

    def span(self, name: str, *, parent=_AMBIENT,
             trace_id: Optional[str] = None, **attrs):
        """Open a span. ``parent`` defaults to the calling thread's
        ambient span; pass an explicit ``SpanContext`` (or ``Span``) to
        parent across threads/processes, or ``None`` to force a new
        root. Always use as (or like) a context manager."""
        if not self.enabled:
            return NOOP_SPAN
        if parent is _AMBIENT:
            parent = current_ctx()
        elif isinstance(parent, Span):
            parent = parent.ctx
        elif isinstance(parent, _NoopSpan):
            parent = None
        return Span(self, name, parent, trace_id, attrs)

    def _record(self, span: Span) -> None:
        with self._lock:
            self._ring.append(span.to_dict())
            self._recorded += 1

    # -- queryable products ----------------------------------------------

    def spans(self, trace_id: Optional[str] = None,
              limit: Optional[int] = None) -> List[Dict]:
        """Finished spans, oldest first, optionally filtered to one
        trace and capped at the most recent ``limit``."""
        with self._lock:
            out = list(self._ring)
        if trace_id is not None:
            out = [s for s in out if s["trace_id"] == trace_id]
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def snapshot(self, trace_id: Optional[str] = None,
                 limit: Optional[int] = None) -> Dict:
        spans = self.spans(trace_id, limit)
        with self._lock:
            recorded, retained = self._recorded, len(self._ring)
        return {"enabled": self.enabled, "capacity": self.capacity,
                "recorded": recorded, "retained": retained,
                "dropped": recorded - retained, "spans": spans}

    def chrome_trace(self, trace_id: Optional[str] = None) -> Dict:
        """Chrome-trace / Perfetto JSON (load via chrome://tracing or
        ui.perfetto.dev). Complete ``X`` events with microsecond
        timestamps off the monotonic clock; span events become ``i``
        instants on the same track."""
        events = []
        threads: Dict[str, int] = {}
        for s in self.spans(trace_id):
            tid = threads.setdefault(s["thread"], len(threads) + 1)
            args = {"trace_id": s["trace_id"], "span_id": s["span_id"],
                    "parent_id": s["parent_id"], **s["attrs"]}
            if s["links"]:
                args["links"] = s["links"]
            events.append({"name": s["name"], "cat": "scaledoc",
                           "ph": "X", "ts": s["start"] * 1e6,
                           "dur": s["duration"] * 1e6,
                           "pid": 1, "tid": tid, "args": args})
            for ev in s["events"]:
                events.append({"name": ev["name"], "cat": "scaledoc",
                               "ph": "i", "ts": ev["t"] * 1e6,
                               "pid": 1, "tid": tid, "s": "t",
                               "args": dict(ev["attrs"])})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"threads": threads}}

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._recorded = 0


NULL_TRACER = Tracer(enabled=False, capacity=1)


# --------------------------------------------------------------------------
# span-tree assembly (debugging / demos / tests)
# --------------------------------------------------------------------------

def span_tree(spans: Sequence[Dict]) -> List[Dict]:
    """Nest a flat span list into ``{"span": ..., "children": [...]}``
    trees (one per root — a span whose parent is None or absent)."""
    nodes = {s["span_id"]: {"span": s, "children": []} for s in spans}
    roots = []
    for s in spans:
        node = nodes[s["span_id"]]
        parent = nodes.get(s["parent_id"]) if s["parent_id"] else None
        if parent is not None:
            parent["children"].append(node)
        else:
            roots.append(node)
    for node in nodes.values():
        node["children"].sort(key=lambda c: c["span"]["start"])
    roots.sort(key=lambda c: c["span"]["start"])
    return roots


def format_span_tree(spans: Sequence[Dict],
                     attrs: Sequence[str] = ("kind",)) -> str:
    """Printable ASCII tree of a span list, durations in ms."""
    lines: List[str] = []

    def walk(node: Dict, prefix: str, last: bool) -> None:
        s = node["span"]
        branch = "" if not prefix and not last else ("`- " if last
                                                     else "|- ")
        extra = " ".join(f"{k}={s['attrs'][k]!r}" for k in attrs
                         if k in s["attrs"])
        lines.append(f"{prefix}{branch}{s['name']} "
                     f"[{s['duration'] * 1e3:.2f} ms]"
                     + (f" {extra}" if extra else ""))
        child_prefix = prefix + ("   " if last else "|  ")
        if not prefix and not last:
            child_prefix = "   "
        kids = node["children"]
        for i, child in enumerate(kids):
            walk(child, child_prefix, i == len(kids) - 1)

    roots = span_tree(spans)
    for i, root in enumerate(roots):
        walk(root, "", i == len(roots) - 1 and len(roots) > 1)
    return "\n".join(lines)


# --------------------------------------------------------------------------
# decision provenance
# --------------------------------------------------------------------------

# Per-document decision classes. Codes are indices into
# PROVENANCE_CLASSES and are what FilterResult.provenance.class_of
# holds (int8; -1 = unclassified, which a completed filter never
# leaves behind).
PROVENANCE_CLASSES = ("proxy_accept", "proxy_reject", "oracle",
                      "cached_label", "topk_skip", "proxy_fallback",
                      "short_circuit", "unresolved")
PROXY_ACCEPT = 0     # root decided True by a leaf threshold (s > r)
PROXY_REJECT = 1     # root decided False by a leaf threshold (s < l)
ORACLE = 2           # ambiguous band, label purchased (or joined)
CACHED_LABEL = 3     # ambiguous band, label already in the shared cache
TOPK_SKIP = 4        # top-k: never walked, or a member beyond k
PROXY_FALLBACK = 5   # degraded: decided by raw proxy score
SHORT_CIRCUIT = 6    # threshold-decided while skipping >=1 later leaf
UNRESOLVED = 7       # degraded defer: parked for post-heal repair
UNCLASSIFIED = -1


@dataclasses.dataclass
class ProvenanceMap:
    """Per-document decision provenance for one ``filter()`` call.

    ``class_of[d]`` is the PROVENANCE_CLASSES index of the mechanism
    that decided document ``d`` at the root; ``leaf_of[d]`` indexes
    ``leaf_names`` (the deciding leaf; -1 when no single leaf applies —
    top-k skips, unresolved parks). Classes are root-relative: with
    negation in the tree, a leaf-level auto-accept can decide the root
    False and is reported as ``proxy_reject`` — the map answers "why is
    doc d in/out of the result", not "what did leaf L score".
    """

    class_of: np.ndarray                  # (n,) int8 codes
    leaf_of: np.ndarray                   # (n,) int16 leaf index or -1
    leaf_names: List[str]
    classes: Tuple[str, ...] = PROVENANCE_CLASSES

    @property
    def n_docs(self) -> int:
        return len(self.class_of)

    def complete(self) -> bool:
        return bool(np.all(self.class_of >= 0))

    def counts(self) -> Dict[str, int]:
        out = {}
        for code, name in enumerate(self.classes):
            c = int(np.sum(self.class_of == code))
            if c:
                out[name] = c
        unknown = int(np.sum(self.class_of < 0))
        if unknown:
            out["unclassified"] = unknown
        return out

    def docs_in(self, name: str) -> np.ndarray:
        code = self.classes.index(name)
        return np.nonzero(self.class_of == code)[0]

    def to_payload(self, mask: Optional[np.ndarray] = None,
                   include_docs: bool = True) -> Dict:
        """The ``/v1/queries/<id>/explain`` body."""
        out = {"n_docs": self.n_docs,
               "legend": list(self.classes),
               "leaves": list(self.leaf_names),
               "counts": self.counts(),
               "complete": self.complete()}
        if include_docs:
            out["class_of"] = self.class_of.astype(int).tolist()
            out["leaf_of"] = self.leaf_of.astype(int).tolist()
        if mask is not None:
            out["accepted_count"] = int(np.sum(mask))
        return out


# --------------------------------------------------------------------------
# cost ledger
# --------------------------------------------------------------------------

def _zero_bucket() -> Dict:
    return {"sessions": 0, "oracle_docs": 0, "oracle_docs_train": 0,
            "oracle_docs_calib": 0, "oracle_docs_online": 0,
            "oracle_flops": 0.0, "proxy_flops": 0.0,
            "cse_reuses": 0, "cse_saved_docs": 0,
            "cse_saved_flops": 0.0, "retry_waste_docs": 0,
            "degraded_sessions": 0}


class CostLedger:
    """Attribution of spend to (tenant, session, leaf).

    ``record_session`` ingests one finished session's per-leaf rows:
    oracle documents this session was *charged* for (training /
    calibration / online band, exactly the broker's per-session
    accounting, so per-tenant oracle-doc totals reconcile against the
    broker's purchase counters), proxy FLOP estimates from the
    executor's docs-scored stats, and — when a leaf artifact or proxy
    was reused rather than built — the estimated documents the reuser
    *didn't* pay, credited as CSE savings. ``record_retry_waste``
    accrues oracle invocations burned by the resilience layer's
    retries (lane-level, attributed to the pseudo-tenant ``_infra``
    because a retry serves every waiter of the batch at once).

    Bounded: per-session detail keeps the most recent ``keep``
    sessions; per-tenant and per-leaf aggregates are O(distinct keys).
    """

    def __init__(self, keep: int = 1024,
                 oracle_flops_per_doc: float = 50e12,
                 proxy_flops_per_doc: float = 0.2e9):
        self._lock = threading.Lock()
        self._sessions: "deque[Dict]" = deque(maxlen=keep)
        self._tenants: Dict[str, Dict] = {}
        self._leaves: Dict[str, Dict] = {}
        self.oracle_flops_per_doc = oracle_flops_per_doc
        self.proxy_flops_per_doc = proxy_flops_per_doc

    @staticmethod
    def _tenant_key(tenant: Optional[str]) -> str:
        return tenant if tenant else "public"

    def record_session(self, *, session_id: str, tenant: Optional[str],
                       name: Optional[str] = None,
                       trace_id: Optional[str] = None,
                       leaves: Sequence[Dict] = (),
                       wall_seconds: float = 0.0,
                       degraded: bool = False) -> None:
        """``leaves`` rows: ``{"leaf", "oracle_docs_train",
        "oracle_docs_calib", "oracle_docs_online", "proxy_flops",
        "reused", "cse_saved_docs"}`` (missing keys default to 0)."""
        tkey = self._tenant_key(tenant)
        entry = {"session": session_id, "tenant": tkey, "name": name,
                 "trace_id": trace_id, "wall_seconds": wall_seconds,
                 "degraded": degraded, "leaves": [dict(l) for l in leaves]}
        with self._lock:
            bucket = self._tenants.setdefault(tkey, _zero_bucket())
            bucket["sessions"] += 1
            if degraded:
                bucket["degraded_sessions"] += 1
            for row in entry["leaves"]:
                train = int(row.get("oracle_docs_train", 0))
                calib = int(row.get("oracle_docs_calib", 0))
                online = int(row.get("oracle_docs_online", 0))
                docs = train + calib + online
                proxy_flops = float(row.get("proxy_flops", 0.0))
                saved = int(row.get("cse_saved_docs", 0))
                reused = bool(row.get("reused", False))
                row["oracle_docs"] = docs
                row["oracle_flops"] = docs * self.oracle_flops_per_doc
                leaf_bucket = self._leaves.setdefault(
                    str(row.get("leaf", "?")), _zero_bucket())
                leaf_bucket["sessions"] += 1
                for target in (bucket, leaf_bucket):
                    target["oracle_docs"] += docs
                    target["oracle_docs_train"] += train
                    target["oracle_docs_calib"] += calib
                    target["oracle_docs_online"] += online
                    target["oracle_flops"] += (docs
                                               * self.oracle_flops_per_doc)
                    target["proxy_flops"] += proxy_flops
                    if reused:
                        target["cse_reuses"] += 1
                        target["cse_saved_docs"] += saved
                        target["cse_saved_flops"] += (
                            saved * self.oracle_flops_per_doc)
            self._sessions.append(entry)

    def record_retry_waste(self, docs: int = 0, retries: int = 0,
                           tenant: Optional[str] = None) -> None:
        tkey = self._tenant_key(tenant or "_infra")
        with self._lock:
            bucket = self._tenants.setdefault(tkey, _zero_bucket())
            bucket["retry_waste_docs"] += int(docs)
            bucket["oracle_flops"] += (int(docs)
                                       * self.oracle_flops_per_doc)

    def tenant_totals(self, tenant: Optional[str]) -> Dict:
        with self._lock:
            got = self._tenants.get(self._tenant_key(tenant))
            return dict(got) if got is not None else _zero_bucket()

    def snapshot(self, recent: int = 32) -> Dict:
        with self._lock:
            sessions = list(self._sessions)[-recent:]
            return {
                "tenants": {k: dict(v) for k, v in self._tenants.items()},
                "leaves": {k: dict(v) for k, v in self._leaves.items()},
                "recent_sessions": sessions,
                "oracle_flops_per_doc": self.oracle_flops_per_doc,
                "proxy_flops_per_doc": self.proxy_flops_per_doc,
            }
