"""The port's network gateway (``repro_torch.gateway``): per-tenant
admission, the HTTP/SSE routes and the stdlib client, on the CPU.

(a) Every test of the JAX package's tests/test_gateway.py that drives the
    gateway, admission or the client runs on the port (its wire-codec
    tests run in tests/test_torch_predicate.py): bitwise parity of four
    concurrent HTTP clients with serial in-process ``filter()``, rate
    and in-flight quotas, saturation as 429, auth and tenant scoping,
    cancel, failures, the ops surface, standing subscriptions over SSE,
    keep-alive after early rejects, 413, and the admission races.
(b) The two packages interoperate over the wire: a ``repro``
    ``GatewayClient`` drives a ``repro_torch`` gateway, and a
    ``repro_torch`` client a ``repro`` gateway, each over the mixed
    leaf/compound workload with the JAX engine's trained params injected
    into every session view of both servers. Each cross pair gets the
    same response payloads (keys, and every value but ids, names and
    times), the same SSE events and masks bitwise equal to the same
    client's run against its own package's gateway, and the oracles
    sell the same label sets. The preconditions of
    tests/test_torch_serve.py hold for this corpus and these params:
    the scores agree to ~1e-7 and none sits at a calibration bin edge,
    so the thresholds and decisions are equal.
"""
import http.client
import json
import threading
import time

import numpy as np
import pytest

from repro.config.base import CascadeConfig as JCascadeCfg
from repro.config.base import ProxyConfig as JProxyCfg
from repro.core.oracle import CachedOracle as JCached
from repro.core.oracle import SimulatedOracle as JOracle
from repro.engine import InMemoryStore as JStore
from repro.engine import ScaleDocEngine as JEngine
from repro.engine import SemanticPredicate as JPred
from repro.gateway import GatewayClient as JClient
from repro.gateway import PredicateGateway as JGateway
from repro.serve import PredicateServer as JServer
from repro_torch.config import CascadeConfig, ProxyConfig
from repro_torch.core.encoder import params_from_jax
from repro_torch.core.oracle import CachedOracle, SimulatedOracle
from repro_torch.data import make_corpus, make_query
from repro_torch.engine import (DriftConfig, InMemoryStore, MemmapStore,
                                ScaleDocEngine, SemanticPredicate,
                                SemanticTopK, StoreWriter)
from repro_torch.gateway import (GatewayClient, GatewayError,
                                 GatewayUnavailable, PredicateGateway,
                                 RateLimited, RemoteQueryFailed, Tenant,
                                 TenantTable, TokenBucket)
from repro_torch.serve import PredicateServer
from torch_threads import one_torch_thread  # noqa: F401

N_DOCS, DIM = 800, 32
PROXY = dict(embed_dim=DIM, hidden_dim=64, latent_dim=32, proj_dim=16,
             phase1_steps=30, phase2_steps=30)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(0, n_docs=N_DOCS, dim=DIM)


@pytest.fixture(scope="module")
def cfgs():
    return ProxyConfig(**PROXY), CascadeConfig(accuracy_target=0.9)


def _workload(corpus):
    """4 mixed compound/leaf predicates over 4 named CachedOracles —
    fresh objects per call so every run labels independently."""
    qs = [make_query(corpus, 100 + i, selectivity=0.3) for i in range(4)]
    cached = [CachedOracle(SimulatedOracle(q.truth)) for q in qs]
    p = [SemanticPredicate(qs[i].embed, cached[i], name=f"p{i}")
         for i in range(4)]
    preds = [p[0], p[1] & ~p[2], p[3] | p[1], p[2]]
    oracles = {f"o{i}": cached[i] for i in range(4)}
    return oracles, preds


def _engine(corpus, cfgs):
    pcfg, ccfg = cfgs
    return ScaleDocEngine(InMemoryStore(corpus.embeds), pcfg, ccfg,
                          device="cpu")


# -- (a) the JAX package's gateway, admission and client tests --------------


def test_client_topk_over_http_matches_engine(corpus, cfgs):
    """GatewayClient.topk() threads the wire topk node end-to-end: the
    remote accepted set equals the in-process SemanticTopK mask."""
    q = make_query(corpus, 9, selectivity=0.3)
    local = _engine(corpus, cfgs).filter(
        SemanticTopK(SemanticPredicate(
            q.embed, CachedOracle(SimulatedOracle(q.truth)), name="t"),
            k=15),
        seed=0)

    cached = CachedOracle(SimulatedOracle(q.truth))
    pred = SemanticPredicate(q.embed, cached, name="t")
    with PredicateServer(_engine(corpus, cfgs), workers=2,
                         max_delay=0.003) as server:
        with PredicateGateway(server, {"o": cached}) as gw:
            client = GatewayClient(gw.url)
            res = client.topk(pred, 15, oracles={"o": cached},
                              timeout=300)
            with pytest.raises(ValueError, match="cannot nest"):
                client.topk({"op": "topk", "k": 2,
                             "child": pred.to_wire({"o": cached})}, 3)
    np.testing.assert_array_equal(np.sort(res["accepted"]),
                                  np.flatnonzero(local.mask))
    assert len(res["accepted"]) == 15


# -- admission units ---------------------------------------------------------


def test_token_bucket_refill_and_retry_hint():
    now = [0.0]
    bucket = TokenBucket(rate=2.0, burst=2.0, clock=lambda: now[0])
    assert bucket.try_acquire() == (True, 0.0)
    assert bucket.try_acquire() == (True, 0.0)
    ok, retry_after = bucket.try_acquire()
    assert not ok and retry_after == pytest.approx(0.5)
    now[0] += 0.5                        # one token refilled
    assert bucket.try_acquire()[0]
    now[0] += 100.0                      # refill caps at burst
    assert bucket.tokens == pytest.approx(2.0)


def test_tenant_table_auth_and_config(tmp_path):
    cfg = tmp_path / "tenants.json"
    cfg.write_text(json.dumps({"tenants": [
        {"name": "acme", "api_key": "k-acme", "rate": 5, "burst": 5,
         "max_in_flight": 2},
        {"name": "globex", "api_key": "k-globex"},
    ]}))
    table = TenantTable.from_file(cfg)
    assert not table.open
    assert table.authenticate("k-acme").tenant.name == "acme"
    assert table.authenticate("wrong") is None
    assert table.authenticate(None) is None
    assert {s["name"] for s in table.snapshot()} == {"acme", "globex"}

    with pytest.raises(ValueError, match="duplicate"):
        TenantTable([Tenant("a", "k"), Tenant("b", "k")])
    with pytest.raises(ValueError, match="rate"):
        Tenant("a", "k", rate=0.0)
    # empty table = open admission: any key (or none) maps to public
    assert TenantTable().authenticate(None).tenant.name == "public"


def test_tenant_state_concurrency_check_spends_no_token():
    now = [0.0]

    class _Done:
        def __init__(self, done):
            self._done = done

        def done(self):
            return self._done

    state = TenantTable(
        [Tenant("t", "k", rate=1.0, burst=1.0, max_in_flight=1)],
        clock=lambda: now[0]).get("t")
    live = _Done(False)
    state.track(live)
    admitted, _, reason = state.admit()
    assert not admitted and reason == "max_in_flight"
    # pinned at max_in_flight did NOT drain the bucket
    assert state.bucket.tokens == pytest.approx(1.0)
    live._done = True                    # lazy pruning frees the slot
    assert state.admit() == (True, 0.0, "")


# -- e2e parity gate ---------------------------------------------------------


def test_http_clients_match_serial_bitwise(corpus, cfgs):
    """Acceptance gate: accept/reject sets over HTTP — and reassembled
    from the SSE delta stream — are bitwise-identical to serial
    in-process filter() with shared label caches, under 4 concurrent
    remote clients."""
    # serial reference: fresh engine per query, sharing CachedOracles
    oracles, preds = _workload(corpus)
    serial_masks = [_engine(corpus, cfgs).filter(p, seed=i).mask
                    for i, p in enumerate(preds)]

    oracles, preds = _workload(corpus)   # fresh oracles for the server
    wires = [p.to_wire(oracles) for p in preds]
    out, errors = {}, []

    with PredicateServer(_engine(corpus, cfgs), workers=4,
                         max_delay=0.003) as server:
        with PredicateGateway(server, oracles) as gw:

            def remote(i):
                try:
                    client = GatewayClient(gw.url)   # one client each
                    sub = client.submit(wires[i], seed=i)
                    sse = list(client.iter_deltas(sub["id"],
                                                  timeout=300))
                    res = client.wait(sub["id"], timeout=300)
                    out[i] = (res, sse)
                except BaseException as exc:  # pragma: no cover
                    errors.append((i, exc))

            threads = [threading.Thread(target=remote, args=(i,))
                       for i in range(len(preds))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

    assert not errors, errors
    for i, mask in enumerate(serial_masks):
        res, sse = out[i]
        accepted = np.nonzero(mask)[0]
        rejected = np.nonzero(~mask)[0]
        np.testing.assert_array_equal(
            np.sort(res["accepted"]), accepted,
            err_msg=f"query {i}: HTTP result diverged from serial")
        np.testing.assert_array_equal(np.sort(res["rejected"]), rejected)
        # the SSE stream reassembles to the same decision sets
        assert sse[-1]["final"]
        sse_acc = np.sort([d for e in sse for d in e["accepted"]])
        sse_rej = np.sort([d for e in sse for d in e["rejected"]])
        np.testing.assert_array_equal(
            sse_acc, accepted,
            err_msg=f"query {i}: SSE stream diverged from serial")
        np.testing.assert_array_equal(sse_rej, rejected)


# -- admission over HTTP -----------------------------------------------------


class _SlowOracle:
    def __init__(self, truth, delay=0.05):
        self._truth = np.asarray(truth, bool)
        self.delay = delay
        self.calls = 0

    def label(self, indices):
        time.sleep(self.delay)
        indices = np.asarray(indices, np.int64)
        self.calls += len(indices)
        return self._truth[indices]


def test_rate_limited_tenant_does_not_slow_others(corpus, cfgs):
    """Acceptance gate: a tenant exceeding its token bucket gets 429 +
    Retry-After; another tenant's concurrently submitted queries are
    admitted and complete untouched."""
    q = make_query(corpus, 7, selectivity=0.3)
    cached = CachedOracle(SimulatedOracle(q.truth))
    oracles = {"o": cached}
    wire = SemanticPredicate(q.embed, cached, name="p").to_wire(oracles)
    tenants = [Tenant("throttled", "k-thr", rate=0.001, burst=1.0),
               Tenant("steady", "k-std", rate=100.0, burst=100.0)]

    with PredicateServer(_engine(corpus, cfgs), workers=2) as server:
        with PredicateGateway(server, oracles, tenants=tenants) as gw:
            thr = GatewayClient(gw.url, api_key="k-thr")
            std = GatewayClient(gw.url, api_key="k-std")

            first = thr.submit(wire, seed=0)       # burst token spent
            with pytest.raises(RateLimited) as exc_info:
                thr.submit(wire, seed=1)
            assert exc_info.value.reason == "rate"
            assert exc_info.value.retry_after >= 1.0

            # the throttled tenant's 429 cost the steady tenant nothing
            subs = [std.submit(wire, seed=i) for i in range(3)]
            for sub in subs + [first]:
                res = std.wait(sub["id"], timeout=300) \
                    if sub in subs else thr.wait(sub["id"], timeout=300)
                assert res["state"] == "done"

            snap = std.metrics()["counters"]
            assert snap["tenant.throttled.rejected_rate"] == 1
            assert snap["tenant.steady.submitted"] == 3
            assert "tenant.steady.rejected_rate" not in snap


def test_max_in_flight_quota_enforced(corpus, cfgs):
    q = make_query(corpus, 7, selectivity=0.3)
    slow = _SlowOracle(q.truth, delay=0.1)
    oracles = {"slow": slow}
    wire = SemanticPredicate(q.embed, slow, name="s").to_wire(oracles)
    tenants = [Tenant("narrow", "k-n", rate=100.0, burst=100.0,
                      max_in_flight=1)]

    with PredicateServer(_engine(corpus, cfgs), workers=2) as server:
        with PredicateGateway(server, oracles, tenants=tenants) as gw:
            client = GatewayClient(gw.url, api_key="k-n")
            first = client.submit(wire, seed=0)
            with pytest.raises(RateLimited) as exc_info:
                client.submit(wire, seed=1)
            assert exc_info.value.reason == "max_in_flight"
            client.wait(first["id"], timeout=300)
            # finished session frees the slot (lazily, at next admit)
            second = client.submit(wire, seed=1)
            client.wait(second["id"], timeout=300)


def test_server_saturation_maps_to_429_not_hang(corpus, cfgs):
    q = make_query(corpus, 7, selectivity=0.3)
    slow = _SlowOracle(q.truth, delay=0.1)
    oracles = {"slow": slow}
    wire = SemanticPredicate(q.embed, slow, name="s").to_wire(oracles)

    with PredicateServer(_engine(corpus, cfgs), workers=1,
                         queue_depth=1) as server:
        with PredicateGateway(server, oracles) as gw:
            client = GatewayClient(gw.url)
            admitted = []
            with pytest.raises(RateLimited) as exc_info:
                for i in range(8):       # 1 running + 1 queued max
                    admitted.append(client.submit(wire, seed=i))
            assert exc_info.value.reason == "saturated"
            assert exc_info.value.retry_after > 0
            assert 1 <= len(admitted) < 8
            for sub in admitted:
                client.wait(sub["id"], timeout=300)


def test_auth_and_tenant_scoping(corpus, cfgs):
    q = make_query(corpus, 7, selectivity=0.3)
    cached = CachedOracle(SimulatedOracle(q.truth))
    oracles = {"o": cached}
    wire = SemanticPredicate(q.embed, cached).to_wire(oracles)
    tenants = [Tenant("a", "k-a"), Tenant("b", "k-b")]

    with PredicateServer(_engine(corpus, cfgs), workers=1) as server:
        with PredicateGateway(server, oracles, tenants=tenants) as gw:
            anon = GatewayClient(gw.url)
            with pytest.raises(GatewayError) as exc_info:
                anon.submit(wire)
            assert exc_info.value.status == 401
            with pytest.raises(GatewayError) as exc_info:
                GatewayClient(gw.url, api_key="bogus").submit(wire)
            assert exc_info.value.status == 401

            a = GatewayClient(gw.url, api_key="k-a")
            b = GatewayClient(gw.url, api_key="k-b")
            sub = a.submit(wire, seed=0)
            a.wait(sub["id"], timeout=300)
            # another tenant cannot even see the session
            with pytest.raises(GatewayError) as exc_info:
                b.status(sub["id"])
            assert exc_info.value.status == 404
            assert a.status(sub["id"])["tenant"] == "a"
            # Bearer auth is equivalent to X-API-Key
            conn = http.client.HTTPConnection(gw.host, gw.port, timeout=10)
            conn.request("GET", f"/v1/queries/{sub['id']}",
                         headers={"Authorization": "Bearer k-a"})
            assert conn.getresponse().status == 200
            conn.close()


# -- lifecycle over the wire -------------------------------------------------


def test_cancel_over_http(corpus, cfgs):
    q = make_query(corpus, 7, selectivity=0.3)
    slow = _SlowOracle(q.truth, delay=0.2)
    oracles = {"slow": slow}
    wire = SemanticPredicate(q.embed, slow, name="s").to_wire(oracles)

    with PredicateServer(_engine(corpus, cfgs), workers=1) as server:
        with PredicateGateway(server, oracles) as gw:
            client = GatewayClient(gw.url)
            running = client.submit(wire, seed=0)
            queued = client.submit(wire, seed=1)   # behind the first
            assert client.cancel(queued["id"])["cancelled"]
            with pytest.raises(RemoteQueryFailed) as exc_info:
                client.wait(queued["id"], timeout=60)
            assert exc_info.value.state == "cancelled"
            assert client.status(queued["id"])["state"] == "cancelled"
            # cancelling a finished session is a no-op
            client.wait(running["id"], timeout=300)
            assert not client.cancel(running["id"])["cancelled"]


def test_failed_session_surfaces_over_http(corpus, cfgs):
    class BadOracle:
        calls = 0

        def label(self, idx):
            raise ValueError("labeler exploded")

    q = make_query(corpus, 7, selectivity=0.3)
    oracles = {"bad": BadOracle()}
    wire = SemanticPredicate(q.embed, oracles["bad"]).to_wire(oracles)
    with PredicateServer(_engine(corpus, cfgs), workers=1) as server:
        with PredicateGateway(server, oracles) as gw:
            client = GatewayClient(gw.url)
            sub = client.submit(wire, seed=0)
            with pytest.raises(RemoteQueryFailed, match="exploded"):
                client.wait(sub["id"], timeout=300)
            # the SSE stream reports the failure as an error event
            with pytest.raises(RemoteQueryFailed, match="exploded"):
                list(client.iter_deltas(sub["id"], timeout=60))


def test_malformed_submission_is_400(corpus, cfgs):
    q = make_query(corpus, 7, selectivity=0.3)
    oracles = {"o": SimulatedOracle(q.truth)}
    with PredicateServer(_engine(corpus, cfgs), workers=1) as server:
        with PredicateGateway(server, oracles) as gw:
            client = GatewayClient(gw.url)
            for bad in ({"op": "xor"}, {"op": "leaf", "oracle": "nope"}):
                with pytest.raises(GatewayError) as exc_info:
                    client.submit(bad)
                assert exc_info.value.status == 400
            snap = client.metrics()["counters"]
            assert snap["tenant.public.rejected_malformed"] == 2


# -- ops surface -------------------------------------------------------------


def test_ops_surface(corpus, cfgs):
    oracles, preds = _workload(corpus)
    wires = [p.to_wire(oracles) for p in preds]
    with PredicateServer(_engine(corpus, cfgs), workers=2) as server:
        with PredicateGateway(server, oracles) as gw:
            client = GatewayClient(gw.url)
            assert client.health() == {"ok": True}
            assert client.ready() == {"ready": True, "docs": N_DOCS,
                                      "state": "ready"}

            subs = [client.submit(w, seed=i)
                    for i, w in enumerate(wires)]
            for sub in subs:
                client.wait(sub["id"], timeout=300)

            snap = client.metrics()
            # acceptance gate: queue depth, micro-batch occupancy,
            # per-tenant counters, latency percentiles — one document
            assert snap["queue"] == {"depth": 0, "capacity": 32}
            assert "oracle_batch_occupancy" in snap["observations"]
            assert snap["counters"]["tenant.public.submitted"] == 4
            lat = snap["observations"]["session_latency_seconds"]
            assert lat["count"] == 4
            assert 0 < lat["p50"] <= lat["p95"] <= lat["p99"] <= \
                lat["max"]
            assert snap["counters"]["gateway_http_2xx"] >= 4
            assert {t["name"] for t in snap["tenants"]} == {"public"}

            admin = client.admin_sessions()
            assert admin["count"] == 4
            assert all(s["state"] == "done"
                       for s in admin["sessions"])
            assert json.loads(json.dumps(snap))  # wire-serializable

    # after server shutdown the gateway reports 503 on submit...
    with PredicateServer(_engine(corpus, cfgs), workers=1) as server:
        pass
    with PredicateGateway(server, oracles) as gw:
        client = GatewayClient(gw.url)
        assert client.ready()["ready"] is False
        with pytest.raises(GatewayUnavailable):
            client.submit(wires[0])


# -- standing predicates over HTTP -------------------------------------------


def _live_store(tmp_path, corpus, rows):
    writer = StoreWriter.open(str(tmp_path), dim=DIM,
                              fingerprint={"model": "gw-live"})
    writer.append(corpus.embeds[:rows])
    writer.commit()
    return writer, MemmapStore.open(str(tmp_path))


def test_standing_over_http_end_to_end(corpus, cfgs, tmp_path):
    """Subscribe / stream / cancel over the wire: the SSE delta events
    reassemble bitwise to the server-side standing decisions, the
    status endpoint exposes the standing stats, and standing ids are
    invisible under /v1/queries (those routes would bypass the
    per-batch admission the standing stream applies)."""
    pcfg, ccfg = cfgs
    writer, store = _live_store(tmp_path, corpus, 400)
    q = make_query(corpus, 9, selectivity=0.3)
    cached = CachedOracle(SimulatedOracle(q.truth))
    oracles = {"o": cached}
    pred = SemanticPredicate(q.embed, cached, name="st")
    engine = ScaleDocEngine(store, pcfg, ccfg, chunk=128, device="cpu")
    with PredicateServer(engine, workers=2) as server:
        server.enable_live(drift=DriftConfig(auto=False))
        with PredicateGateway(server, oracles) as gw:
            client = GatewayClient(gw.url)
            sub = client.subscribe_standing(pred, oracles=oracles, seed=2)
            assert sub["state"] == "live"
            assert sub["watermark"] == 400 and sub["calib_rows"] == 400

            events = []
            consumer = threading.Thread(
                target=lambda: events.extend(
                    client.iter_standing(sub["id"], timeout=120)),
                daemon=True)
            consumer.start()

            writer.append(corpus.embeds[400:N_DOCS])
            writer.commit()
            writer.close()
            server.live.pump()

            status = client.standing_status(sub["id"])
            assert status["standing"] is True
            assert status["watermark"] == N_DOCS
            assert status["delta_batches"] == 1

            # standing ids do not resolve as query sessions
            for path in (f"/v1/queries/{sub['id']}",
                         f"/v1/queries/{sub['id']}/deltas"):
                with pytest.raises(GatewayError) as exc_info:
                    client._request("GET", path)
                assert exc_info.value.status == 404

            sp = server.live.get(sub["id"])
            decisions = sp.decisions
            assert client.cancel_standing(sub["id"])["cancelled"]
            consumer.join(timeout=60)
            assert not consumer.is_alive()

    deltas = [e for e in events if not e["final"]]
    assert [(e["lo"], e["hi"]) for e in deltas] == [(400, N_DOCS)]
    assert events[-1]["final"]
    mask = np.zeros(N_DOCS - 400, bool)
    for e in deltas:
        mask[np.asarray(e["accepted"], np.int64) - 400] = True
        assert not np.intersect1d(e["accepted"], e["rejected"]).size
    np.testing.assert_array_equal(mask, decisions[400:])


def test_standing_stream_throttled_but_lossless(corpus, cfgs, tmp_path):
    """Per-batch admission: an over-rate tenant's standing stream is
    delayed batch by batch (standing_throttled counts the stalls) but
    every batch still arrives, in order."""
    pcfg, ccfg = cfgs
    writer, store = _live_store(tmp_path, corpus, 500)
    q = make_query(corpus, 11, selectivity=0.3)
    cached = CachedOracle(SimulatedOracle(q.truth))
    oracles = {"o": cached}
    pred = SemanticPredicate(q.embed, cached, name="st")
    tenants = [Tenant("slow", "k-s", rate=2.0, burst=1.0)]
    engine = ScaleDocEngine(store, pcfg, ccfg, chunk=128, device="cpu")
    with PredicateServer(engine, workers=2) as server:
        server.enable_live(drift=DriftConfig(auto=False))
        with PredicateGateway(server, oracles, tenants=tenants) as gw:
            client = GatewayClient(gw.url, api_key="k-s")
            sub = client.subscribe_standing(pred, oracles=oracles, seed=4)
            events = []
            consumer = threading.Thread(
                target=lambda: events.extend(
                    client.iter_standing(sub["id"], timeout=120)),
                daemon=True)
            consumer.start()
            for lo, hi in ((500, 600), (600, 700), (700, N_DOCS)):
                writer.append(corpus.embeds[lo:hi])
                writer.commit()
                server.live.pump()
            writer.close()
            client.cancel_standing(sub["id"])
            consumer.join(timeout=60)
            assert not consumer.is_alive()
            snap = client.metrics()["counters"]
            assert snap["tenant.slow.standing_throttled"] >= 1
    deltas = [e for e in events if not e["final"]]
    assert [(e["lo"], e["hi"]) for e in deltas] == \
        [(500, 600), (600, 700), (700, N_DOCS)]
    assert events[-1]["final"]


def test_standing_counts_toward_max_in_flight(corpus, cfgs):
    """A live subscription holds a concurrency slot until cancelled:
    with max_in_flight=1 both a second standing subscribe and an
    ordinary query submit are quota-rejected; cancel frees the slot."""
    pcfg, ccfg = cfgs
    q = make_query(corpus, 13, selectivity=0.3)
    cached = CachedOracle(SimulatedOracle(q.truth))
    oracles = {"o": cached}
    pred = SemanticPredicate(q.embed, cached, name="st")
    wire = pred.to_wire(oracles)
    tenants = [Tenant("narrow", "k-n", rate=100.0, burst=100.0,
                      max_in_flight=1)]
    engine = ScaleDocEngine(InMemoryStore(corpus.embeds), pcfg, ccfg,
                            device="cpu")
    with PredicateServer(engine, workers=2) as server:
        server.enable_live(drift=DriftConfig(auto=False))
        with PredicateGateway(server, oracles, tenants=tenants) as gw:
            client = GatewayClient(gw.url, api_key="k-n")
            sub = client.subscribe_standing(pred, oracles=oracles, seed=0)
            for attempt in (lambda: client.subscribe_standing(
                    pred, oracles=oracles, seed=1),
                    lambda: client.submit(wire, seed=1)):
                with pytest.raises(RateLimited) as exc_info:
                    attempt()
                assert exc_info.value.reason == "max_in_flight"
            client.cancel_standing(sub["id"])
            # the cancelled subscription frees its slot (lazy prune)
            done = client.submit(wire, seed=1)
            client.wait(done["id"], timeout=300)


def test_standing_requires_live_mode(corpus, cfgs):
    """Without enable_live() the gateway maps the server's refusal to
    503 — a static deployment, not an error in the request."""
    pcfg, ccfg = cfgs
    q = make_query(corpus, 15, selectivity=0.3)
    cached = CachedOracle(SimulatedOracle(q.truth))
    oracles = {"o": cached}
    pred = SemanticPredicate(q.embed, cached, name="st")
    engine = ScaleDocEngine(InMemoryStore(corpus.embeds), pcfg, ccfg,
                            device="cpu")
    with PredicateServer(engine, workers=1) as server:
        with PredicateGateway(server, oracles) as gw:
            client = GatewayClient(gw.url)
            with pytest.raises(GatewayUnavailable):
                client.subscribe_standing(pred, oracles=oracles)
            with pytest.raises(GatewayError) as exc_info:
                client.standing_status("no-such-standing")
            assert exc_info.value.status == 404


# -- HTTP robustness ---------------------------------------------------------


def _post(conn, body, key=None, path="/v1/queries"):
    headers = {"Content-Type": "application/json"}
    if key:
        headers["X-API-Key"] = key
    conn.request("POST", path, body=json.dumps(body).encode(),
                 headers=headers)
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read() or b"{}"), resp


def test_keepalive_survives_early_reject_responses(corpus, cfgs):
    """Regression: 401/429 responses are sent before the request body
    is read; on an HTTP/1.1 keep-alive connection the unread bytes must
    not be parsed as the next request (previously: '400 Bad request
    syntax' for every standard keep-alive client)."""
    q = make_query(corpus, 7, selectivity=0.3)
    cached = CachedOracle(SimulatedOracle(q.truth))
    oracles = {"o": cached}
    wire = SemanticPredicate(q.embed, cached).to_wire(oracles)
    tenants = [Tenant("throttled", "k-thr", rate=0.001, burst=1.0),
               Tenant("steady", "k-std", rate=100.0, burst=100.0)]

    with PredicateServer(_engine(corpus, cfgs), workers=2) as server:
        with PredicateGateway(server, oracles, tenants=tenants) as gw:
            conn = http.client.HTTPConnection(gw.host, gw.port,
                                              timeout=30)
            body = {"predicate": wire, "pad": "x" * 4096}
            # 401 with a 4 KiB body the handler never read...
            status, _, _ = _post(conn, body, key="bogus")
            assert status == 401
            # ...must not corrupt the next request on the same socket
            status, first, _ = _post(conn, body, key="k-std")
            assert status == 202
            # same for a rate-limit 429 (rejected before the body read)
            status, second, _ = _post(conn, body, key="k-thr")
            assert status == 202          # burst token spent
            status, _, _ = _post(conn, body, key="k-thr")
            assert status == 429
            status, third, _ = _post(conn, body, key="k-std")
            assert status == 202
            conn.close()
            std = GatewayClient(gw.url, api_key="k-std")
            thr = GatewayClient(gw.url, api_key="k-thr")
            for client, sub in [(std, first), (thr, second),
                                (std, third)]:
                assert client.wait(sub["id"],
                                   timeout=300)["state"] == "done"


def test_oversized_body_is_413_and_closes_connection(corpus, cfgs,
                                                     monkeypatch):
    from repro_torch.gateway import gateway as gateway_mod
    monkeypatch.setattr(gateway_mod, "MAX_BODY_BYTES", 1024)
    oracles, _ = _workload(corpus)
    with PredicateServer(_engine(corpus, cfgs), workers=1) as server:
        with PredicateGateway(server, oracles) as gw:
            conn = http.client.HTTPConnection(gw.host, gw.port,
                                              timeout=10)
            conn.request("POST", "/v1/queries", body=b"x" * 4096,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 413
            # the body is never read, so the connection must close
            assert resp.getheader("Connection") == "close"
            assert "exceeds" in json.loads(resp.read())["error"]
            conn.close()
            snap = GatewayClient(gw.url).metrics()["counters"]
            assert snap["tenant.public.rejected_oversized"] == 1


def test_bad_timeout_parameter_is_400(corpus, cfgs):
    q = make_query(corpus, 7, selectivity=0.3)
    cached = CachedOracle(SimulatedOracle(q.truth))
    oracles = {"o": cached}
    wire = SemanticPredicate(q.embed, cached).to_wire(oracles)
    with PredicateServer(_engine(corpus, cfgs), workers=1) as server:
        with PredicateGateway(server, oracles) as gw:
            client = GatewayClient(gw.url)
            sub = client.submit(wire, seed=0)
            with pytest.raises(GatewayError) as exc_info:
                client._request(
                    "GET", f"/v1/queries/{sub['id']}/result?timeout=abc")
            assert exc_info.value.status == 400
            client.wait(sub["id"], timeout=300)


def test_concurrent_admits_cannot_exceed_max_in_flight():
    """Regression: N racing submits from one tenant could all pass the
    in_flight check before any track() — admit() now reserves the slot
    atomically."""
    class _Live:
        def done(self):
            return False

    state = TenantTable([Tenant("t", "k", rate=1000.0, burst=1000.0,
                                max_in_flight=2)]).get("t")
    results = []
    barrier = threading.Barrier(8)

    def worker():
        barrier.wait()
        results.append(state.admit()[0])

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(results) == 2
    # release() frees a reserved slot before any session exists
    state.release()
    assert state.admit() == (True, 0.0, "")
    # track() converts its reservation instead of double-charging
    state.track(_Live())
    assert state.in_flight() == 2
    assert state.admit()[2] == "max_in_flight"


def test_failed_submit_releases_concurrency_slot(corpus, cfgs):
    q = make_query(corpus, 7, selectivity=0.3)
    cached = CachedOracle(SimulatedOracle(q.truth))
    oracles = {"o": cached}
    wire = SemanticPredicate(q.embed, cached).to_wire(oracles)
    tenants = [Tenant("narrow", "k-n", rate=100.0, burst=100.0,
                      max_in_flight=1)]
    with PredicateServer(_engine(corpus, cfgs), workers=1) as server:
        with PredicateGateway(server, oracles, tenants=tenants) as gw:
            client = GatewayClient(gw.url, api_key="k-n")
            with pytest.raises(GatewayError) as exc_info:
                client.submit({"op": "xor"})
            assert exc_info.value.status == 400
            # the 400 released the reserved slot: a good submit fits
            sub = client.submit(wire, seed=0)
            client.wait(sub["id"], timeout=300)


def test_ops_surface_requires_auth_with_tenant_table(corpus, cfgs):
    """Regression: with a closed tenant table, /v1/metrics and
    /v1/admin/sessions required no key and leaked every tenant's
    session ids — now 401 unauthenticated, and the admin listing is
    scoped to the caller unless its tenant record sets admin=True."""
    q = make_query(corpus, 7, selectivity=0.3)
    cached = CachedOracle(SimulatedOracle(q.truth))
    oracles = {"o": cached}
    wire = SemanticPredicate(q.embed, cached).to_wire(oracles)
    tenants = [Tenant("a", "k-a"), Tenant("b", "k-b"),
               Tenant("ops", "k-ops", admin=True)]
    with PredicateServer(_engine(corpus, cfgs), workers=2) as server:
        with PredicateGateway(server, oracles, tenants=tenants) as gw:
            anon = GatewayClient(gw.url)
            for call in (anon.metrics, anon.admin_sessions):
                with pytest.raises(GatewayError) as exc_info:
                    call()
                assert exc_info.value.status == 401

            a = GatewayClient(gw.url, api_key="k-a")
            b = GatewayClient(gw.url, api_key="k-b")
            ops = GatewayClient(gw.url, api_key="k-ops")
            a.wait(a.submit(wire, seed=0)["id"], timeout=300)
            b.wait(b.submit(wire, seed=1)["id"], timeout=300)
            # non-admin tenants see only their own sessions
            mine = a.admin_sessions()
            assert mine["count"] == 1
            assert {s["tenant"] for s in mine["sessions"]} == {"a"}
            # an admin tenant sees the full registry
            assert ops.admin_sessions()["count"] == 2
            # any authenticated tenant can read metrics
            assert a.metrics()["counters"]["tenant.a.submitted"] == 1


def test_unknown_route_is_404(corpus, cfgs):
    oracles, _ = _workload(corpus)
    with PredicateServer(_engine(corpus, cfgs), workers=1) as server:
        with PredicateGateway(server, oracles) as gw:
            client = GatewayClient(gw.url)
            with pytest.raises(GatewayError) as exc_info:
                client._request("GET", "/v1/nonsense")
            assert exc_info.value.status == 404
            with pytest.raises(GatewayError) as exc_info:
                client.status("no-such-session")
            assert exc_info.value.status == 404


# -- (b) the two packages over the wire ---------------------------------------


def _with_params(engine, params):
    """Every session view the server opens starts from ``params`` (leaf
    key -> proxy) as cached proxies, so both packages score with the same
    proxies and train none."""
    open_view = engine.session_view

    def session_view(**kw):
        view = open_view(**kw)
        view._proxies.update(params)
        return view
    engine.session_view = session_view
    return engine


@pytest.fixture(scope="module")
def jax_leaf_params(corpus):
    """The mixed workload's four leaves, trained once by the JAX engine."""
    qs = [make_query(corpus, 100 + i, selectivity=0.3) for i in range(4)]
    je = JEngine(JStore(corpus.embeds), JProxyCfg(**PROXY),
                 JCascadeCfg(accuracy_target=0.9))
    leaves = [JPred(q.embed, JOracle(q.truth)) for q in qs]
    je.filter(leaves[0] & leaves[1] & leaves[2] & leaves[3], seed=0)
    return qs, [je._proxies[p.key] for p in leaves]


def _side(package, corpus, cfgs, qs, params):
    """One package's server stack: its engine with the injected params,
    its named oracle registry, the raw oracles and the workload's wires
    (the wire format is shared, so either package's client sends them)."""
    if package == "jax":
        sims = [JOracle(q.truth) for q in qs]
        cached = [JCached(s) for s in sims]
        leaves = [JPred(q.embed, c, name=f"p{i}")
                  for i, (q, c) in enumerate(zip(qs, cached))]
        engine = _with_params(
            JEngine(JStore(corpus.embeds), JProxyCfg(**PROXY),
                    JCascadeCfg(accuracy_target=0.9)),
            {a.key: p for a, p in zip(leaves, params)})
        server_cls, gateway_cls = JServer, JGateway
    else:
        sims = [SimulatedOracle(q.truth) for q in qs]
        cached = [CachedOracle(s) for s in sims]
        leaves = [SemanticPredicate(q.embed, c, name=f"p{i}")
                  for i, (q, c) in enumerate(zip(qs, cached))]
        engine = _with_params(
            _engine(corpus, cfgs),
            {b.key: params_from_jax(p) for b, p in zip(leaves, params)})
        server_cls, gateway_cls = PredicateServer, PredicateGateway
    oracles = {f"o{i}": c for i, c in enumerate(cached)}
    p = leaves
    wires = [pred.to_wire(oracles)
             for pred in (p[0], p[1] & ~p[2], p[3] | p[1], p[2])]
    return engine, server_cls, gateway_cls, oracles, sims, wires


def _drive(client_cls, side):
    """Four sessions through one gateway: the submit bodies, the result
    bodies, the second session's SSE events and the status bodies."""
    engine, server_cls, gateway_cls, oracles, sims, wires = side
    with server_cls(engine, workers=4, max_delay=0.003) as server:
        with gateway_cls(server, oracles) as gw:
            client = client_cls(gw.url)
            subs = [client.submit(w, seed=i) for i, w in enumerate(wires)]
            sse = list(client.iter_deltas(subs[1]["id"], timeout=300))
            results = [client.wait(s["id"], timeout=300) for s in subs]
            status = [client.status(s["id"]) for s in subs]
    return {"subs": subs, "results": results, "sse": sse,
            "status": status, "queried": [s.queried for s in sims]}


# which session pays for a label two sessions share depends on the
# interleaving, so per-session oracle calls are compared only in sum
_VARYING = {"id", "name", "wall_seconds", "trace_id", "states",
            "oracle_wait_seconds", "queue_wait_seconds", "run_seconds",
            "oracle_calls_total"}


def _same_payloads(got, want):
    for a, b in zip(got["subs"], want["subs"]):
        assert a.keys() == b.keys()
        assert a["tenant"] == b["tenant"]
    for i, (a, b) in enumerate(zip(got["results"], want["results"])):
        assert a.keys() == b.keys()
        for key in a.keys() - _VARYING:
            assert a[key] == b[key], (i, key)
    assert sum(r["oracle_calls_total"] for r in got["results"]) == \
        sum(r["oracle_calls_total"] for r in want["results"])
    for a, b in zip(got["status"], want["status"]):
        assert a.keys() == b.keys()
        assert (a["state"], a["tenant"]) == (b["state"], b["tenant"])
    assert [e.keys() for e in got["sse"]] == [e.keys() for e in want["sse"]]
    for key in ("accepted", "rejected"):
        assert np.array_equal(
            np.sort([d for e in got["sse"] for d in e[key]]),
            np.sort([d for e in want["sse"] for d in e[key]]))
    assert got["sse"][-1]["final"]
    assert got["queried"] == want["queried"]


def test_jax_client_drives_the_port_gateway(corpus, cfgs, jax_leaf_params):
    """A ``repro`` GatewayClient against a ``repro_torch`` gateway gets
    what it gets from a ``repro`` gateway: the same payloads and masks."""
    qs, params = jax_leaf_params
    cross = _drive(JClient, _side("port", corpus, cfgs, qs, params))
    home = _drive(JClient, _side("jax", corpus, cfgs, qs, params))
    _same_payloads(cross, home)
    for res in cross["results"]:
        assert res["state"] == "done" and res["oracle_calls_train"] == 0
        assert len(res["accepted"]) + len(res["rejected"]) == N_DOCS


def test_port_client_drives_the_jax_gateway(corpus, cfgs, jax_leaf_params):
    """A ``repro_torch`` GatewayClient against a ``repro`` gateway gets
    what it gets from a ``repro_torch`` gateway."""
    qs, params = jax_leaf_params
    cross = _drive(GatewayClient, _side("jax", corpus, cfgs, qs, params))
    home = _drive(GatewayClient, _side("port", corpus, cfgs, qs, params))
    _same_payloads(cross, home)
    for res in cross["results"]:
        assert res["state"] == "done" and res["oracle_calls_train"] == 0
