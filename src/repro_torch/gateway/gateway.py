"""PredicateGateway — the HTTP/SSE service plane over PredicateServer
(a copy of ``repro.gateway.gateway``).

Everything behind this module already exists in-process: the
``PredicateServer`` runs concurrent sessions with explicit lifecycle
states, streamed deltas and a metrics snapshot. The gateway is the
wire: a stdlib-only (``http.server.ThreadingHTTPServer``,
zero new dependencies) front end that turns those APIs into a network
service with per-tenant admission and a live ops surface.

    POST   /v1/queries               submit a wire-format predicate AST
    GET    /v1/queries/<id>          session state + stats
    GET    /v1/queries/<id>/result   decisions (blocks up to ?timeout=)
    GET    /v1/queries/<id>/deltas   accepted/rejected doc-id deltas as
                                     server-sent events (final sentinel
                                     -> `done` event -> stream close)
    GET    /v1/queries/<id>/explain  decision provenance: per-doc
                                     deciding mechanism + leaf
                                     (?docs=0 -> counts only)
    DELETE /v1/queries/<id>          cooperative cancel
    POST   /v1/standing              register a standing predicate over
                                     the live store (continuous query)
    GET    /v1/standing/<id>         watermark / drift / delta stats
    GET    /v1/standing/<id>/deltas  SSE stream of per-commit-group
                                     accept/reject batches; tenant
                                     admission applied per pushed batch
                                     (over-rate tenants are throttled,
                                     batches delayed — never dropped)
    DELETE /v1/standing/<id>         cancel the standing predicate
    GET    /healthz | /readyz        liveness | engine-resident+store-open
    GET    /v1/metrics               CounterSet snapshot: queue depth,
                                     micro-batch occupancy, per-tenant
                                     counters, latency p50/p95/p99, the
                                     cost ledger and tracer stats
                                     (?format=prometheus -> text
                                     exposition of the CounterSet)
    GET    /v1/traces                flight-recorder spans
                                     (?trace_id= filters one trace,
                                     ?limit= caps, ?format=chrome ->
                                     Chrome-trace/Perfetto JSON)
    GET    /v1/admin/sessions        live session registry with states
                                     (scoped to the caller's tenant
                                     unless it has ``admin=True``)

Admission is layered: API key -> tenant (401, on the ops endpoints too
when a tenant table is configured), oversized body (413, connection
closed unread), token-bucket rate and max-in-flight quota (429 +
``Retry-After``, the concurrency slot reserved atomically so racing
submits cannot overshoot, enforced *before* the server's admission
queue so a throttled tenant costs the pool nothing), then
``PredicateServer.submit`` (``ServerSaturated`` -> 429,
``ServerClosed`` -> 503, both with ``Retry-After`` — backpressure is a
status code, never a hung request). Early rejections drain the unread
request body so HTTP/1.1 keep-alive connections stay parseable.

Decisions over the wire are exactly in-process decisions: the AST
rebuilds each leaf bit-exactly
(``repro_torch.engine.predicate.from_wire``) against the gateway's named
oracle registry, so sessions share the same ``CachedOracle`` objects,
caches and RNG streams as a serial ``filter()`` — the end-to-end parity
gate in ``tests/test_torch_gateway.py``. The wire format is the JAX
package's, so a client of either package drives a gateway of either.
The gateway runs no device code: sessions run on the server's engine.
"""
from __future__ import annotations

import json
import math
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Mapping, Optional

import numpy as np

from repro_torch.core.oracle import OracleUnavailable
from repro_torch.engine.predicate import WireFormatError, from_wire
from repro_torch.gateway.admission import TenantState, TenantTable
from repro_torch.runtime import trace as trace_mod
from repro_torch.runtime.metrics import (PROMETHEUS_CONTENT_TYPE,
                                   render_prometheus)
from repro_torch.serve.server import (PredicateServer, QuerySession,
                                ServerClosed, ServerSaturated,
                                SessionCancelled, SessionState,
                                StandingSession)

MAX_BODY_BYTES = 8 << 20            # request bodies larger than this: 413
SATURATED_RETRY_AFTER = 1.0         # hint when the admission queue is full
CLOSED_RETRY_AFTER = 5.0


class BodyTooLarge(Exception):
    """Request body exceeds ``MAX_BODY_BYTES`` — maps to 413. The body
    is never read, so the keep-alive connection is closed after the
    response instead of being drained."""


def _retry_header(seconds: float) -> Dict[str, str]:
    return {"Retry-After": str(max(1, math.ceil(seconds)))}


class _GatewayHTTPServer(ThreadingHTTPServer):
    # SSE streams pin handler threads; daemonize so close() never hangs
    # on a client that keeps its stream open
    daemon_threads = True

    def __init__(self, addr, handler, gateway: "PredicateGateway"):
        super().__init__(addr, handler)
        self.gateway = gateway


class PredicateGateway:
    """HTTP/SSE front end over one ``PredicateServer``.

    ``oracles`` is the name -> oracle registry wire predicates resolve
    against (names are what leaves carry; the objects are what sessions
    label with). ``tenants`` is a ``TenantTable``, a list of ``Tenant``
    records, a JSON config path, or ``None`` for open admission.
    ``embedder`` (prompt -> embedding) enables ``prompt`` leaves. The
    listener starts immediately on ``host:port`` (port 0 = ephemeral;
    read it back from ``gateway.port``/``gateway.url``).
    """

    def __init__(self, server: PredicateServer,
                 oracles: Mapping[str, object], *,
                 tenants=None, embedder=None,
                 host: str = "127.0.0.1", port: int = 0,
                 stream_timeout: float = 600.0,
                 keepalive_interval: float = 15.0,
                 reap_on_disconnect: bool = True):
        self.server = server
        # SSE liveness: idle streams emit `: keep-alive` comment frames
        # every keepalive_interval seconds so client read timeouts don't
        # kill healthy-but-quiet standing subscriptions; a failed socket
        # write reaps the subscriber (reap_on_disconnect) so dead
        # clients release their max_in_flight slot and delta queue
        self.keepalive_interval = keepalive_interval
        self.reap_on_disconnect = reap_on_disconnect
        self.counters = server.counters
        self.oracles = dict(oracles)
        if isinstance(tenants, TenantTable):
            self.tenants = tenants
        elif isinstance(tenants, (str, bytes)) or hasattr(tenants,
                                                          "read_text"):
            self.tenants = TenantTable.from_file(tenants)
        else:
            self.tenants = TenantTable(tenants)
        self.embedder = embedder
        self.stream_timeout = stream_timeout
        self._httpd = _GatewayHTTPServer((host, port), _Handler, self)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="scaledoc-gateway", daemon=True)
        self._thread.start()

    # -- addressing ------------------------------------------------------

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- lifecycle -------------------------------------------------------

    def close(self) -> None:
        """Stop accepting connections and release the listener. The
        underlying ``PredicateServer`` is not touched — it may serve
        other fronts; shut it down separately (or nest context
        managers: ``with server: with gateway: ...``)."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)

    def __enter__(self) -> "PredicateGateway":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- request-level operations (handler delegates here) ---------------

    def submit(self, tenant: TenantState, body: Dict,
               trace_ctx: Optional[trace_mod.SpanContext] = None
               ) -> QuerySession:
        # breaker-open fast-fail: with degrade="fail" every session
        # would burn a worker slot just to fail — reject at the door
        # with the breaker's own retry horizon instead. Degrading
        # servers (defer/proxy_fallback) keep accepting: that is what
        # the degrade policy is *for*.
        if self.server.degrade == "fail":
            health = self.server.oracle_health()
            if health["state"] == "open":
                raise OracleUnavailable(
                    "oracle circuit open; queries would fail — retry "
                    "after the breaker half-opens",
                    retry_after=health["retry_after"]
                    or CLOSED_RETRY_AFTER, breaker_open=True)
        pred = from_wire(body["predicate"], oracles=self.oracles,
                         embedder=self.embedder)
        target = body.get("accuracy_target")
        session = self.server.submit(
            pred,
            accuracy_target=None if target is None else float(target),
            seed=int(body.get("seed", 0)),
            name=body.get("name"),
            tenant=tenant.tenant.name,
            trace_ctx=trace_ctx)
        tenant.track(session)
        return session

    def subscribe(self, tenant: TenantState, body: Dict) -> StandingSession:
        """Register a standing predicate for this tenant. The session
        counts against ``max_in_flight`` until cancelled — a standing
        subscription is a permanently-live query."""
        pred = from_wire(body["predicate"], oracles=self.oracles,
                         embedder=self.embedder)
        target = body.get("accuracy_target")
        session = self.server.subscribe(
            pred,
            accuracy_target=None if target is None else float(target),
            seed=int(body.get("seed", 0)),
            name=body.get("name"),
            tenant=tenant.tenant.name)
        tenant.track(session)
        return session

    def lookup(self, session_id: str,
               tenant: Optional[TenantState]) -> Optional[QuerySession]:
        """Session by id, scoped to the requesting tenant: with a closed
        tenant table a session is invisible (404, not 403 — ids are
        unguessable but still should not leak) to everyone but its
        owner."""
        session = self.server.get_session(session_id)
        if session is None:
            return None
        if (not self.tenants.open and tenant is not None
                and session.tenant != tenant.tenant.name):
            return None
        return session

    def metrics_snapshot(self) -> Dict:
        snap = self.server.metrics_snapshot()
        snap["tenants"] = self.tenants.snapshot()
        return snap

    def readiness(self) -> Dict:
        reason = None
        docs = 0
        if self.server.closed:
            reason = "server closed"
        else:
            try:
                docs = len(self.server.engine.store)
            except Exception as exc:  # store unreadable = not ready
                reason = f"store not open: {exc}"
            else:
                if docs == 0:
                    reason = "store is empty"
        out = {"ready": reason is None, "docs": docs,
               **({"reason": reason} if reason else {})}
        if reason is not None:
            out["state"] = "unready"
            return out
        # a tripped breaker or a non-empty repair queue is a *distinct*
        # degraded state: still serving (200 — load balancers must not
        # eject the instance; the oracle outage is global, not ours),
        # but operators and probes can tell at a glance
        health = self.server.oracle_health()
        degraded = (health["state"] != "closed"
                    or health["repair_queue"] > 0)
        out["state"] = "degraded" if degraded else "ready"
        if degraded:
            out["oracle"] = health
            out["degrade_policy"] = self.server.degrade
        return out


# degraded defer results can leave most of a large collection
# unresolved; the JSON payload carries a count plus a bounded sample of
# ids, never the full O(n_docs) list (the repair queue holds the truth)
UNRESOLVED_SAMPLE_CAP = 64


def _result_payload(session: QuerySession) -> Dict:
    res = session._result
    mask = res.mask
    return {"done": True, "state": session.state.value,
            "id": session.id, "name": session.name,
            "tenant": session.tenant,
            "accepted": np.nonzero(mask)[0].tolist(),
            "rejected": np.nonzero(~mask)[0].tolist(),
            "n_docs": int(res.n_docs),
            "oracle_calls_total": int(res.oracle_calls_total),
            "oracle_calls_train": int(res.oracle_calls_train),
            "plan": res.plan,
            "wall_seconds": res.wall_seconds,
            "achieved_f1": res.achieved_f1,
            "achieved_exact": res.achieved_exact,
            "degraded": res.degraded,
            **({"degrade_mode": res.degrade_mode,
                "unresolved_count": int(len(res.unresolved)),
                "unresolved_sample": np.asarray(
                    res.unresolved,
                    np.int64)[:UNRESOLVED_SAMPLE_CAP].tolist(),
                "fallback_docs": int(res.fallback_docs),
                "est_accuracy_debit": float(res.est_accuracy_debit),
                "error": res.error} if res.degraded else {})}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "scaledoc-gateway"

    def log_message(self, *args):    # request logging -> CounterSet only
        pass

    @property
    def gw(self) -> PredicateGateway:
        return self.server.gateway

    # -- verbs -----------------------------------------------------------

    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def do_DELETE(self):
        self._route("DELETE")

    # -- routing ---------------------------------------------------------

    def _route(self, method: str) -> None:
        t0 = time.perf_counter()
        self._status = 500
        self._body_read = False
        try:
            split = urllib.parse.urlsplit(self.path)
            self._query = dict(urllib.parse.parse_qsl(split.query))
            parts = [p for p in split.path.split("/") if p]
            self._dispatch(method, parts)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True
        except Exception as exc:  # noqa: BLE001 — service boundary
            try:
                self._json(500, {"error": f"{type(exc).__name__}: {exc}"})
            except OSError:
                pass
        finally:
            self._drain_unread_body()
            c = self.gw.counters
            c.inc("gateway_requests")
            c.inc(f"gateway_http_{self._status // 100}xx")
            c.observe("gateway_request_seconds",
                      time.perf_counter() - t0)

    def _drain_unread_body(self) -> None:
        """Responses on early-reject paths (401/413/429/...) are sent
        before the request body is read; on an HTTP/1.1 keep-alive
        connection the unread bytes would otherwise be parsed as the
        *next* request. Consume them here — or, when the body is
        oversized or unreadable, close the connection instead."""
        if self._body_read:
            return
        self._body_read = True
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
        except ValueError:
            self.close_connection = True
            return
        if length <= 0:
            return
        if length > MAX_BODY_BYTES:
            self.close_connection = True
            return
        try:
            remaining = length
            while remaining > 0:
                chunk = self.rfile.read(min(remaining, 1 << 16))
                if not chunk:
                    self.close_connection = True
                    return
                remaining -= len(chunk)
        except OSError:
            self.close_connection = True

    def _dispatch(self, method: str, parts) -> None:
        if method == "GET" and parts == ["healthz"]:
            return self._json(200, {"ok": True})
        if method == "GET" and parts == ["readyz"]:
            ready = self.gw.readiness()
            return self._json(200 if ready["ready"] else 503, ready)
        if method == "GET" and parts == ["v1", "metrics"]:
            if self._tenant() is None:   # closed table: 401, not a leak
                return self._json(401, {"error": "unknown or missing "
                                                 "API key"})
            if self._query.get("format") == "prometheus":
                # the scrapeable form: just the CounterSet (counters,
                # gauges + peaks, observation summaries) — the nested
                # subsystem blocks stay JSON-only
                return self._text(
                    200, render_prometheus(self.gw.counters.snapshot()),
                    content_type=PROMETHEUS_CONTENT_TYPE)
            return self._json(200, self.gw.metrics_snapshot())
        if method == "GET" and parts == ["v1", "traces"]:
            if self._tenant() is None:
                return self._json(401, {"error": "unknown or missing "
                                                 "API key"})
            limit = self._query.get("limit")
            try:
                limit = int(limit) if limit is not None else None
            except ValueError:
                return self._json(400, {"error": f"bad limit parameter "
                                                 f"{limit!r}"})
            return self._json(200, self.gw.server.trace_snapshot(
                trace_id=self._query.get("trace_id"), limit=limit,
                chrome=self._query.get("format") == "chrome"))
        if method == "GET" and parts == ["v1", "admin", "sessions"]:
            tenant = self._tenant()
            if tenant is None:
                return self._json(401, {"error": "unknown or missing "
                                                 "API key"})
            sessions = self.gw.server.sessions()
            if not self.gw.tenants.open and not tenant.tenant.admin:
                # non-admin tenants see only their own sessions — ids
                # are unguessable and must not leak across tenants
                sessions = [s for s in sessions
                            if s.tenant == tenant.tenant.name]
            stats = [s.stats() for s in sessions]
            return self._json(200, {"count": len(stats),
                                    "sessions": stats})
        if parts[:2] == ["v1", "queries"]:
            return self._queries(method, parts[2:])
        if parts[:2] == ["v1", "standing"]:
            return self._standing(method, parts[2:])
        self._json(404, {"error": f"no route {method} {self.path}"})

    def _queries(self, method: str, rest) -> None:
        tenant = self._tenant()
        if tenant is None:
            return self._json(401, {"error": "unknown or missing API "
                                             "key"})
        name = tenant.tenant.name
        self.gw.tenants.fold_counters(self.gw.counters, name, "requests")
        if method == "POST" and not rest:
            return self._submit(tenant)
        if len(rest) >= 1:
            session = self.gw.lookup(rest[0], tenant)
            if session is None or isinstance(session, StandingSession):
                # standing sessions live under /v1/standing — routing
                # them here would bypass the per-batch admission the
                # standing SSE stream applies
                return self._json(404, {"error": f"no session "
                                                 f"{rest[0]!r}"})
            if method == "GET" and len(rest) == 1:
                return self._json(200, session.stats())
            if method == "GET" and rest[1:] == ["result"]:
                return self._result(session)
            if method == "GET" and rest[1:] == ["explain"]:
                return self._explain(session)
            if method == "GET" and rest[1:] == ["deltas"]:
                return self._sse(session)
            if method == "DELETE" and len(rest) == 1:
                cancelled = session.cancel()
                return self._json(200, {"cancelled": cancelled,
                                        "state": session.state.value})
        self._json(404, {"error": f"no route {method} {self.path}"})

    def _standing(self, method: str, rest) -> None:
        tenant = self._tenant()
        if tenant is None:
            return self._json(401, {"error": "unknown or missing API "
                                             "key"})
        name = tenant.tenant.name
        self.gw.tenants.fold_counters(self.gw.counters, name, "requests")
        if method == "POST" and not rest:
            return self._subscribe(tenant)
        if len(rest) >= 1:
            session = self.gw.lookup(rest[0], tenant)
            if session is None or not isinstance(session,
                                                 StandingSession):
                return self._json(404, {"error": f"no standing "
                                                 f"predicate "
                                                 f"{rest[0]!r}"})
            if method == "GET" and len(rest) == 1:
                return self._json(200, session.stats())
            if method == "GET" and rest[1:] == ["deltas"]:
                return self._sse_standing(session, tenant)
            if method == "DELETE" and len(rest) == 1:
                cancelled = session.cancel()
                return self._json(200, {"cancelled": cancelled,
                                        "state": session.state.value})
        self._json(404, {"error": f"no route {method} {self.path}"})

    # -- endpoints -------------------------------------------------------

    def _submit(self, tenant: TenantState) -> None:
        name = tenant.tenant.name
        counters = self.gw.counters
        fold = self.gw.tenants.fold_counters
        admitted, retry_after, reason = tenant.admit()
        if not admitted:
            fold(counters, name, "rejected_rate" if reason == "rate"
                 else "rejected_quota")
            return self._json(
                429, {"error": f"tenant {name!r} over its "
                               f"{reason} limit",
                      "reason": reason, "retry_after": retry_after},
                headers=_retry_header(retry_after))
        # context propagation: a caller-supplied W3C `traceparent` header
        # parents the whole server-side trace on the caller's span; the
        # gateway's own request span sits between it and the session span
        # (malformed headers parse to None — degrade, never reject)
        ctx = trace_mod.parse_traceparent(self.headers.get("traceparent"))
        gspan = self.gw.server.tracer.span(
            "gateway.request", parent=ctx, kind="gateway",
            route="POST /v1/queries", tenant=name)
        try:
            try:
                with gspan:
                    body = self._body()
                    session = self.gw.submit(
                        tenant, body, trace_ctx=gspan.ctx or ctx)
                    gspan.set(session=session.id)
            except BaseException:
                tenant.release()    # return the slot admit() reserved
                raise
        except BodyTooLarge as exc:
            fold(counters, name, "rejected_oversized")
            # the oversized body is never read: close, don't drain
            return self._json(413, {"error": str(exc)},
                              headers={"Connection": "close"})
        except WireFormatError as exc:
            fold(counters, name, "rejected_malformed")
            return self._json(400, {"error": str(exc)})
        except (KeyError, TypeError, ValueError) as exc:
            fold(counters, name, "rejected_malformed")
            return self._json(400, {"error": f"bad request body: "
                                             f"{exc}"})
        except ServerSaturated as exc:
            # global backpressure surfaces as a status code + hint, not
            # a request parked on the admission queue
            fold(counters, name, "rejected_saturated")
            return self._json(
                429, {"error": str(exc), "reason": "saturated",
                      "retry_after": SATURATED_RETRY_AFTER},
                headers=_retry_header(SATURATED_RETRY_AFTER))
        except ServerClosed as exc:
            return self._json(
                503, {"error": str(exc),
                      "retry_after": CLOSED_RETRY_AFTER},
                headers=_retry_header(CLOSED_RETRY_AFTER))
        except OracleUnavailable as exc:
            # oracle circuit open on a fail-mode server: 503 with the
            # breaker's retry horizon — the outage is upstream of us
            fold(counters, name, "rejected_oracle_down")
            retry_after = exc.retry_after or CLOSED_RETRY_AFTER
            return self._json(
                503, {"error": str(exc), "reason": "oracle_unavailable",
                      "retry_after": retry_after},
                headers=_retry_header(retry_after))
        fold(counters, name, "submitted")
        self._json(202, {"id": session.id, "name": session.name,
                         "tenant": name,
                         "state": session.state.value,
                         "trace_id": session.trace_id})

    def _subscribe(self, tenant: TenantState) -> None:
        name = tenant.tenant.name
        counters = self.gw.counters
        fold = self.gw.tenants.fold_counters
        admitted, retry_after, reason = tenant.admit()
        if not admitted:
            fold(counters, name, "rejected_rate" if reason == "rate"
                 else "rejected_quota")
            return self._json(
                429, {"error": f"tenant {name!r} over its "
                               f"{reason} limit",
                      "reason": reason, "retry_after": retry_after},
                headers=_retry_header(retry_after))
        try:
            try:
                body = self._body()
                session = self.gw.subscribe(tenant, body)
            except BaseException:
                tenant.release()    # return the slot admit() reserved
                raise
        except BodyTooLarge as exc:
            fold(counters, name, "rejected_oversized")
            return self._json(413, {"error": str(exc)},
                              headers={"Connection": "close"})
        except WireFormatError as exc:
            fold(counters, name, "rejected_malformed")
            return self._json(400, {"error": str(exc)})
        except (KeyError, TypeError, ValueError) as exc:
            fold(counters, name, "rejected_malformed")
            return self._json(400, {"error": f"bad request body: "
                                             f"{exc}"})
        except ServerClosed as exc:
            return self._json(
                503, {"error": str(exc),
                      "retry_after": CLOSED_RETRY_AFTER},
                headers=_retry_header(CLOSED_RETRY_AFTER))
        except OracleUnavailable as exc:
            # subclasses RuntimeError, so this arm must precede the
            # static-deployment arm below
            fold(counters, name, "rejected_oracle_down")
            retry_after = exc.retry_after or CLOSED_RETRY_AFTER
            return self._json(
                503, {"error": str(exc), "reason": "oracle_unavailable",
                      "retry_after": retry_after},
                headers=_retry_header(retry_after))
        except RuntimeError as exc:
            # live collections not enabled on this server — a static
            # deployment; ServerClosed subclasses RuntimeError so this
            # arm must come second
            return self._json(503, {"error": str(exc)})
        fold(counters, name, "standing_subscribed")
        self._json(202, {"id": session.id, "name": session.name,
                         "tenant": name,
                         "state": session.state.value,
                         "watermark": session.standing.watermark,
                         "calib_rows": session.standing.calib_rows})

    def _result(self, session: QuerySession) -> None:
        try:
            timeout = min(float(self._query.get("timeout", 0.0)),
                          self.gw.stream_timeout)
        except ValueError:
            return self._json(400, {"error": f"bad timeout parameter "
                                             f"{self._query['timeout']!r}"})
        try:
            session.result(timeout=timeout)
        except TimeoutError:
            return self._json(202, {"done": False,
                                    "state": session.state.value,
                                    "id": session.id})
        except SessionCancelled as exc:
            return self._json(409, {"done": True, "state": "cancelled",
                                    "error": str(exc)})
        except BaseException as exc:  # the session's own failure
            return self._json(500, {"done": True, "state": "failed",
                                    "error": f"{type(exc).__name__}: "
                                             f"{exc}"})
        self._json(200, _result_payload(session))

    def _explain(self, session: QuerySession) -> None:
        """Decision provenance for a finished session: per-doc deciding
        mechanism + leaf. ``?docs=0`` drops the O(n_docs) arrays."""
        include = self._query.get("docs", "1") not in ("0", "false")
        try:
            payload = self.gw.server.explain(session.id,
                                             include_docs=include)
        except RuntimeError as exc:
            # still running — provenance exists only once filter() ends
            return self._json(409, {"error": str(exc),
                                    "state": session.state.value,
                                    "id": session.id})
        except BaseException as exc:   # the session's own failure
            return self._json(500, {"error": f"{type(exc).__name__}: "
                                             f"{exc}",
                                    "state": session.state.value})
        self._json(200, payload)

    def _sse(self, session: QuerySession) -> None:
        """Stream the session's accepted/rejected deltas as server-sent
        events; the engine's final sentinel becomes a ``done`` event and
        the stream closes."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        self._status = 200
        # poll the resumable get_delta() primitive instead of
        # iter_deltas(): an idle wait becomes a ": keep-alive" comment
        # frame (so client read timeouts and NAT entries don't expire)
        # rather than a dead generator, while stream_timeout still
        # bounds the wall-clock wait for the *next real delta*
        deadline = time.monotonic() + self.gw.stream_timeout
        poll = max(self.gw.keepalive_interval, 0.010)
        seen = 0
        try:
            while True:
                delta = session.get_delta(
                    seen, timeout=min(poll, self.gw.stream_timeout))
                if delta is None:
                    if time.monotonic() >= deadline:
                        raise TimeoutError(
                            f"{session.name}: no delta within "
                            f"{self.gw.stream_timeout}s")
                    self.wfile.write(b": keep-alive\n\n")
                    self.wfile.flush()
                    self.gw.counters.inc("gateway_sse_keepalives")
                    continue
                seen += 1
                deadline = time.monotonic() + self.gw.stream_timeout
                event = "done" if delta.final else "delta"
                payload = {"seq": delta.seq,
                           "accepted": np.asarray(delta.accepted,
                                                  np.int64).tolist(),
                           "rejected": np.asarray(delta.rejected,
                                                  np.int64).tolist(),
                           "state": session.state.value}
                self._event(event, payload)
                self.gw.counters.inc("gateway_sse_events")
                if delta.final:
                    return
        except (BrokenPipeError, ConnectionResetError):
            pass                      # client went away mid-stream
        except BaseException as exc:  # session failed / stream timed out
            try:
                self._event("error", {"error": f"{type(exc).__name__}: "
                                               f"{exc}",
                                      "state": session.state.value})
            except OSError:
                pass

    def _sse_standing(self, session: StandingSession,
                      tenant: TenantState) -> None:
        """Stream a standing predicate's per-commit-group delta batches
        as server-sent events. Tenant admission applies *per pushed
        batch*: each batch spends one token from the tenant's bucket,
        and an over-rate tenant's stream is throttled — the batch is
        delayed until a token accrues, never dropped (the queue between
        the pump and this stream is unbounded and order-preserving, so
        decisions delivered are still exactly the decisions made)."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        self._status = 200
        counters = self.gw.counters
        fold = self.gw.tenants.fold_counters
        name = tenant.tenant.name
        # standing streams are long-lived and mostly idle between commit
        # groups: emit keep-alive comment frames on idle waits, and when
        # a write shows the client is *gone* (broken pipe / reset), reap
        # the subscriber — close the subscription queue (so the pump
        # stops accumulating batches for a dead socket) and, with
        # reap_on_disconnect, cancel the session so its max_in_flight
        # slot frees immediately. Stream deadlines and transient write
        # errors end only this stream; the subscription survives them
        deadline = time.monotonic() + self.gw.stream_timeout
        poll = max(self.gw.keepalive_interval, 0.010)
        try:
            while True:
                try:
                    batch = session.subscription.get(
                        timeout=min(poll, self.gw.stream_timeout))
                except TimeoutError:
                    if time.monotonic() >= deadline:
                        raise
                    self.wfile.write(b": keep-alive\n\n")
                    self.wfile.flush()
                    counters.inc("gateway_sse_keepalives")
                    continue
                deadline = time.monotonic() + self.gw.stream_timeout
                while not batch.final:   # final sentinel is admission-free
                    ok, retry_after = tenant.bucket.try_acquire()
                    if ok:
                        break
                    fold(counters, name, "standing_throttled")
                    time.sleep(min(retry_after, 1.0))
                event = "done" if batch.final else "delta"
                payload = {"seq": batch.seq,
                           "lo": batch.lo, "hi": batch.hi,
                           "accepted": np.asarray(batch.accepted,
                                                  np.int64).tolist(),
                           "rejected": np.asarray(batch.rejected,
                                                  np.int64).tolist(),
                           "revalidated": batch.revalidated,
                           "rows_scored": batch.rows_scored,
                           "oracle_calls": batch.oracle_calls,
                           "state": session.state.value}
                self._event(event, payload)
                counters.inc("gateway_sse_events")
                if batch.final:
                    return
        except TimeoutError as exc:
            # stream deadline: the subscriber is healthy, just quiet —
            # tell it and let it reconnect; never reap (TimeoutError IS
            # an OSError, so this arm must precede the disconnect arms)
            try:
                self._event("error", {"error": f"{type(exc).__name__}: "
                                               f"{exc}",
                                      "state": session.state.value})
            except OSError:
                pass
        except (BrokenPipeError, ConnectionResetError):
            # client socket is gone — reap so the dead subscriber can't
            # leak its queue or hold a tenant concurrency slot
            session.subscription.close()
            if self.gw.reap_on_disconnect:
                session.cancel()
            fold(counters, name, "standing_reaped")
        except OSError:
            # transient write failure (e.g. EAGAIN on a slow client):
            # end this stream but keep the subscription and session
            # alive so the client can reconnect and resume
            pass
        except BaseException as exc:  # cancelled / session failed
            try:
                self._event("error", {"error": f"{type(exc).__name__}: "
                                               f"{exc}",
                                      "state": session.state.value})
            except OSError:
                pass

    def _event(self, name: str, payload: Dict) -> None:
        blob = json.dumps(payload, default=float)
        self.wfile.write(f"event: {name}\ndata: {blob}\n\n".encode())
        self.wfile.flush()

    # -- plumbing --------------------------------------------------------

    def _tenant(self) -> Optional[TenantState]:
        key = self.headers.get("X-API-Key")
        if key is None:
            auth = self.headers.get("Authorization", "")
            if auth.startswith("Bearer "):
                key = auth[len("Bearer "):]
        return self.gw.tenants.authenticate(key)

    def _body(self) -> Dict:
        length = int(self.headers.get("Content-Length", 0))
        if length > MAX_BODY_BYTES:
            raise BodyTooLarge(f"body of {length} bytes exceeds "
                               f"{MAX_BODY_BYTES}")
        raw = self.rfile.read(length) if length else b"{}"
        self._body_read = True
        try:
            body = json.loads(raw)
        except json.JSONDecodeError as exc:
            raise ValueError(f"body is not JSON: {exc}") from None
        if not isinstance(body, dict):
            raise ValueError("body must be a JSON object")
        if "predicate" not in body:
            raise KeyError("'predicate'")
        return body

    def _json(self, status: int, payload: Dict,
              headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(payload, default=float).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(body)
        self._status = status

    def _text(self, status: int, text: str, *,
              content_type: str = "text/plain; charset=utf-8") -> None:
        body = text.encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        self._status = status
