"""GatewayClient — thin stdlib HTTP client for the predicate gateway
(a copy of ``repro.gateway.client``; it speaks the JAX package's wire
format, so it drives a gateway of either package).

One class, no dependencies beyond ``http.client``: serialize a
predicate with ``to_wire()``, POST it, then either block on
``wait()``/``filter()`` for the final accepted/rejected id lists or
consume ``iter_deltas()`` to stream decisions as leaves resolve.
Admission failures surface as typed exceptions carrying the server's
``Retry-After`` hint (``RateLimited``) or outage semantics
(``GatewayUnavailable``); a query that *ran* and failed raises
``RemoteQueryFailed`` with the server-side error string.
"""
from __future__ import annotations

import http.client
import json
import time
import urllib.parse
from typing import Dict, Iterator, Mapping, Optional

from repro_torch.engine.predicate import Predicate
from repro_torch.runtime import trace as trace_mod


class GatewayError(RuntimeError):
    """Gateway request rejected; ``status`` is the HTTP status code."""

    def __init__(self, message: str, status: int = 0):
        super().__init__(message)
        self.status = status


class RateLimited(GatewayError):
    """429 — per-tenant quota or global saturation; retry after
    ``retry_after`` seconds."""

    def __init__(self, message: str, retry_after: float, reason: str = ""):
        super().__init__(message, status=429)
        self.retry_after = retry_after
        self.reason = reason


class GatewayUnavailable(GatewayError):
    """503 — server shut down or not ready."""

    def __init__(self, message: str, retry_after: float = 5.0):
        super().__init__(message, status=503)
        self.retry_after = retry_after


class RemoteQueryFailed(GatewayError):
    """The query was admitted but its session failed or was cancelled."""

    def __init__(self, message: str, state: str = "failed",
                 status: int = 500):
        super().__init__(message, status=status)
        self.state = state


class GatewayClient:
    """Client for one gateway endpoint, optionally as one tenant.

    ``base_url`` is ``http://host:port``; ``api_key`` is the tenant
    credential (omit against an open gateway). Connections are
    per-request, so one client instance is safe to share across
    threads.
    """

    def __init__(self, base_url: str, api_key: Optional[str] = None,
                 timeout: float = 30.0):
        parsed = urllib.parse.urlsplit(base_url)
        if parsed.scheme not in ("", "http"):
            raise ValueError(f"unsupported scheme {parsed.scheme!r}")
        netloc = parsed.netloc or parsed.path
        self.host, _, port = netloc.partition(":")
        self.port = int(port or 80)
        self.api_key = api_key
        self.timeout = timeout

    # -- core ------------------------------------------------------------

    def _headers(self) -> Dict[str, str]:
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["X-API-Key"] = self.api_key
        return headers

    def _request(self, method: str, path: str, body: Optional[Dict] = None,
                 timeout: Optional[float] = None, check: bool = True,
                 headers: Optional[Dict[str, str]] = None):
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=timeout or self.timeout)
        try:
            payload = (json.dumps(body).encode()
                       if body is not None else None)
            conn.request(method, path, body=payload,
                         headers={**self._headers(), **(headers or {})})
            resp = conn.getresponse()
            raw = resp.read()
            data = json.loads(raw) if raw else {}
            if check:
                self._raise_for_status(resp, data)
            return resp.status, data
        finally:
            conn.close()

    @staticmethod
    def _raise_for_status(resp, data: Dict) -> None:
        status = resp.status
        if status < 400:
            return
        message = data.get("error", f"HTTP {status}")
        if status == 429:
            header = resp.getheader("Retry-After")
            retry_after = float(data.get(
                "retry_after", header if header is not None else 1.0))
            raise RateLimited(message, retry_after=retry_after,
                              reason=data.get("reason", ""))
        if status == 503:
            raise GatewayUnavailable(message,
                                     retry_after=float(
                                         data.get("retry_after", 5.0)))
        if status in (409, 500) and data.get("done"):
            raise RemoteQueryFailed(message,
                                    state=data.get("state", "failed"),
                                    status=status)
        raise GatewayError(message, status=status)

    # -- queries ---------------------------------------------------------

    def submit(self, predicate, *,
               oracles: Optional[Mapping[str, object]] = None,
               accuracy_target: Optional[float] = None, seed: int = 0,
               name: Optional[str] = None,
               trace_ctx=None) -> Dict:
        """Submit a predicate — either an already-encoded wire dict or a
        ``Predicate`` plus the ``oracles`` name registry it serializes
        against. Returns the 202 body (``id``, ``state``,
        ``trace_id``, ...). ``trace_ctx`` — a ``trace.SpanContext``, a
        ``Span``, or a preformatted ``traceparent`` string — propagates
        the caller's trace context so the server-side spans parent onto
        it (and the returned ``trace_id`` is the caller's)."""
        if isinstance(predicate, Predicate):
            predicate = predicate.to_wire(oracles)
        body = {"predicate": predicate, "seed": seed}
        if accuracy_target is not None:
            body["accuracy_target"] = accuracy_target
        if name is not None:
            body["name"] = name
        headers = {}
        if trace_ctx is not None:
            ctx = getattr(trace_ctx, "ctx", trace_ctx)
            headers["traceparent"] = (
                ctx if isinstance(ctx, str)
                else trace_mod.make_traceparent(ctx))
        _, data = self._request("POST", "/v1/queries", body=body,
                                headers=headers)
        return data

    def status(self, session_id: str) -> Dict:
        _, data = self._request("GET", f"/v1/queries/{session_id}")
        return data

    def wait(self, session_id: str, timeout: float = 600.0,
             interval: float = 5.0) -> Dict:
        """Block until the query finishes (long-polling the result
        endpoint every ``interval`` seconds); returns the result body
        with ``accepted``/``rejected`` doc-id lists. Raises
        ``RemoteQueryFailed`` if the session failed or was cancelled,
        ``TimeoutError`` past ``timeout``."""
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"query {session_id} still running "
                                   f"after {timeout}s")
            poll = min(interval, remaining)
            status, data = self._request(
                "GET", f"/v1/queries/{session_id}/result"
                       f"?timeout={poll:.3f}",
                timeout=poll + self.timeout)
            if status == 200:
                return data
            # 202: still running — poll again

    def filter(self, predicate, *,
               oracles: Optional[Mapping[str, object]] = None,
               accuracy_target: Optional[float] = None, seed: int = 0,
               name: Optional[str] = None,
               timeout: float = 600.0) -> Dict:
        """submit() + wait(): the one-call remote analogue of
        ``ScaleDocEngine.filter``."""
        submitted = self.submit(predicate, oracles=oracles,
                                accuracy_target=accuracy_target,
                                seed=seed, name=name)
        return self.wait(submitted["id"], timeout=timeout)

    def topk(self, predicate, k: int, *,
             oracles: Optional[Mapping[str, object]] = None,
             accuracy_target: Optional[float] = None, seed: int = 0,
             name: Optional[str] = None,
             timeout: float = 600.0) -> Dict:
        """The k best-scoring documents satisfying ``predicate``:
        wraps it in a wire ``topk`` node (``SemanticTopK`` semantics —
        root-only, cascade-decided membership) and runs filter().
        ``predicate`` may be a ``Predicate`` or an already-encoded wire
        dict; it must not already be a topk node."""
        if isinstance(predicate, Predicate):
            predicate = predicate.to_wire(oracles)
        if predicate.get("op") == "topk":
            raise ValueError("predicate is already a topk node; "
                             "topk cannot nest")
        node = {"op": "topk", "k": k, "child": predicate}
        return self.filter(node, accuracy_target=accuracy_target,
                           seed=seed, name=name, timeout=timeout)

    def cancel(self, session_id: str) -> Dict:
        _, data = self._request("DELETE", f"/v1/queries/{session_id}")
        return data

    def explain(self, session_id: str,
                include_docs: bool = True) -> Dict:
        """Decision provenance for a finished query: which mechanism
        (proxy threshold / oracle / cached label / fallback / ...)
        decided every document, and at which leaf."""
        docs = "1" if include_docs else "0"
        _, data = self._request(
            "GET", f"/v1/queries/{session_id}/explain?docs={docs}")
        return data

    def traces(self, trace_id: Optional[str] = None,
               limit: Optional[int] = None,
               chrome: bool = False) -> Dict:
        """Flight-recorder spans from the server's tracer, optionally
        filtered to one trace id; ``chrome=True`` fetches Chrome-trace/
        Perfetto JSON instead of the raw span list."""
        params = {}
        if trace_id is not None:
            params["trace_id"] = trace_id
        if limit is not None:
            params["limit"] = str(limit)
        if chrome:
            params["format"] = "chrome"
        qs = ("?" + urllib.parse.urlencode(params)) if params else ""
        _, data = self._request("GET", f"/v1/traces{qs}")
        return data

    def iter_deltas(self, session_id: str,
                    timeout: float = 600.0) -> Iterator[Dict]:
        """Stream the session's SSE deltas as dicts with a ``final``
        flag; ends after the ``done`` event. An ``error`` event raises
        ``RemoteQueryFailed``."""
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout)
        try:
            conn.request("GET", f"/v1/queries/{session_id}/deltas",
                         headers=self._headers())
            resp = conn.getresponse()
            if resp.status != 200:
                raw = resp.read()
                data = json.loads(raw) if raw else {}
                self._raise_for_status(resp, data)
                raise GatewayError(data.get("error", "stream refused"),
                                   status=resp.status)
            yield from self._parse_sse(resp)
        finally:
            conn.close()

    @staticmethod
    def _parse_sse(resp) -> Iterator[Dict]:
        event: Optional[str] = None
        data_lines = []
        while True:
            line = resp.readline()
            if not line:
                return          # stream closed
            line = line.decode("utf-8").rstrip("\r\n")
            if line.startswith("event:"):
                event = line[len("event:"):].strip()
                continue
            if line.startswith("data:"):
                data_lines.append(line[len("data:"):].strip())
                continue
            if line:            # comment / unknown field — skip
                continue
            if not data_lines:  # blank keep-alive
                continue
            payload = json.loads("\n".join(data_lines))
            kind, event, data_lines = event or "message", None, []
            if kind == "error":
                raise RemoteQueryFailed(payload.get("error", "stream "
                                                             "error"),
                                        state=payload.get("state",
                                                          "failed"))
            payload["final"] = kind == "done"
            yield payload
            if payload["final"]:
                return

    # -- standing predicates ---------------------------------------------

    def subscribe_standing(self, predicate, *,
                           oracles: Optional[Mapping[str, object]] = None,
                           accuracy_target: Optional[float] = None,
                           seed: int = 0,
                           name: Optional[str] = None) -> Dict:
        """Register a standing predicate over the gateway's live store.
        Returns the 202 body (``id``, ``watermark``, ``calib_rows``,
        ...); stream its per-commit-group decisions with
        ``iter_standing()``."""
        if isinstance(predicate, Predicate):
            predicate = predicate.to_wire(oracles)
        body = {"predicate": predicate, "seed": seed}
        if accuracy_target is not None:
            body["accuracy_target"] = accuracy_target
        if name is not None:
            body["name"] = name
        _, data = self._request("POST", "/v1/standing", body=body)
        return data

    def standing_status(self, standing_id: str) -> Dict:
        _, data = self._request("GET", f"/v1/standing/{standing_id}")
        return data

    def cancel_standing(self, standing_id: str) -> Dict:
        _, data = self._request("DELETE", f"/v1/standing/{standing_id}")
        return data

    def iter_standing(self, standing_id: str,
                      timeout: float = 600.0) -> Iterator[Dict]:
        """Stream a standing predicate's per-batch deltas as dicts with
        a ``final`` flag; ends after the ``done`` event that follows
        cancellation. Each dict carries ``lo``/``hi`` (the commit-group
        row window), ``accepted``/``rejected`` doc ids and a
        ``revalidated`` flag — a revalidated batch *replaces* all
        decisions below its ``hi`` rather than appending."""
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout)
        try:
            conn.request("GET", f"/v1/standing/{standing_id}/deltas",
                         headers=self._headers())
            resp = conn.getresponse()
            if resp.status != 200:
                raw = resp.read()
                data = json.loads(raw) if raw else {}
                self._raise_for_status(resp, data)
                raise GatewayError(data.get("error", "stream refused"),
                                   status=resp.status)
            yield from self._parse_sse(resp)
        finally:
            conn.close()

    # -- ops surface -----------------------------------------------------

    def health(self) -> Dict:
        return self._request("GET", "/healthz")[1]

    def ready(self) -> Dict:
        """Readiness body (``{"ready": bool, ...}``) — returned, not
        raised, even when the gateway answers 503."""
        return self._request("GET", "/readyz", check=False)[1]

    def metrics(self) -> Dict:
        return self._request("GET", "/v1/metrics")[1]

    def metrics_prometheus(self) -> str:
        """The ``?format=prometheus`` text exposition, as a string."""
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        try:
            conn.request("GET", "/v1/metrics?format=prometheus",
                         headers=self._headers())
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status >= 400:
                data = {}
                try:
                    data = json.loads(raw)
                except json.JSONDecodeError:
                    pass
                self._raise_for_status(resp, data)
            return raw.decode("utf-8")
        finally:
            conn.close()

    def admin_sessions(self) -> Dict:
        return self._request("GET", "/v1/admin/sessions")[1]
