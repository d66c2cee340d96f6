"""The port's online serving subsystem (``repro_torch.serve``):
PredicateServer sessions, the OracleBroker micro-batcher, the metrics
sinks, and the concurrent-vs-serial bit-parity gate.

(a) The JAX package's broker and server tests (tests/test_serve.py) run
    on the port, on the CPU, its two standing-session tests among them
    (the server's live plane over ``repro_torch.engine.live``).
(b) Parity: the mixed leaf/compound workload on the JAX server and on
    the port's, each session's proxies trained by the JAX engine and
    injected into both (through the engine's session views): equal
    plans and masks, session by session, and equal label sets bought,
    oracle by oracle; and ``render_prometheus`` gives the JAX package's
    text for one snapshot. The preconditions of tests/test_torch_compound.py hold for
    this corpus: with injected params the scores agree to ~1e-7 and no
    score sits at a calibration bin edge, so the thresholds are equal.
"""
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
from repro.runtime.metrics import CounterSet as JCounterSet
from repro.runtime.metrics import render_prometheus as j_render
from repro.serve import PredicateServer as JServer
from repro_torch.config import CascadeConfig, ProxyConfig
from repro_torch.core.encoder import params_from_jax
from repro_torch.core.oracle import CachedOracle, SimulatedOracle
from repro_torch.data import make_corpus, make_query
from repro_torch.engine import (DriftConfig, InMemoryStore, MemmapStore,
                                ScaleDocEngine, SemanticPredicate,
                                StoreWriter)
from repro_torch.runtime.metrics import (PROMETHEUS_CONTENT_TYPE,
                                         CounterSet, Metrics,
                                         render_prometheus)
from repro_torch.serve import (OracleBroker, OracleUnavailable,
                               PredicateServer, ServerClosed,
                               ServerSaturated, SessionState,
                               StandingSession, StandingState)
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


def _engine(corpus, cfgs):
    pcfg, ccfg = cfgs
    return ScaleDocEngine(InMemoryStore(corpus.embeds), pcfg, ccfg,
                          device="cpu")


def _mixed_workload(corpus):
    """4 mixed compound/leaf requests over 4 distinct oracles (fresh
    oracle objects per call so runs are independent)."""
    qs = [make_query(corpus, 100 + i, selectivity=0.3) for i in range(4)]
    sims = [SimulatedOracle(q.truth) for q in qs]
    cached = [CachedOracle(s) for s in sims]
    p = [SemanticPredicate(qs[i].embed, cached[i], name=f"p{i}")
         for i in range(4)]
    preds = [p[0], p[1] & ~p[2], p[3] | p[1], p[2]]
    return sims, preds


def _serial_baseline(corpus, cfgs):
    """Serial filter() calls, each on a fresh engine, sharing the
    CachedOracles: the parity reference the server must reproduce."""
    sims, preds = _mixed_workload(corpus)
    masks = [_engine(corpus, cfgs).filter(pred, seed=i).mask
             for i, pred in enumerate(preds)]
    return masks, sum(s.calls for s in sims)


# -- (a) acceptance gate: concurrent == serial, bit for bit -------------------

def test_concurrent_server_matches_serial_bitwise(corpus, cfgs):
    serial_masks, serial_calls = _serial_baseline(corpus, cfgs)
    sims, preds = _mixed_workload(corpus)
    with PredicateServer(_engine(corpus, cfgs), workers=4,
                         max_delay=0.003) as server:
        sessions = [server.submit(p, seed=i) for i, p in enumerate(preds)]
        results = [s.result(timeout=300) for s in sessions]
        snap = server.metrics_snapshot()
    for i, (mask, res) in enumerate(zip(serial_masks, results)):
        np.testing.assert_array_equal(
            mask, res.mask, err_msg=f"query {i} diverged from serial")
    assert sum(s.calls for s in sims) <= serial_calls
    assert all(s.state == SessionState.DONE for s in sessions)
    # fault-free, the ledger's oracle documents reconcile exactly with the
    # oracles' purchases and the broker's flush counters
    ledger = sum(t["oracle_docs"]
                 for t in snap["cost_ledger"]["tenants"].values())
    assert ledger == sum(s.calls for s in sims) \
        == snap["counters"]["oracle_docs_flushed"] \
        == snap["oracle_cache"]["docs_purchased"]


def test_repeated_submissions_are_deterministic(corpus, cfgs):
    runs = []
    for _ in range(2):
        _, preds = _mixed_workload(corpus)
        with PredicateServer(_engine(corpus, cfgs), workers=3) as server:
            runs.append([r.mask for r in
                         server.run(preds, seeds=range(len(preds)))])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


# -- (a) broker --------------------------------------------------------------

def test_broker_coalesces_concurrent_asks():
    truth = np.random.default_rng(0).random(600) < 0.4
    inner = SimulatedOracle(truth)
    cached = CachedOracle(inner)
    counters = CounterSet()
    broker = OracleBroker(max_batch=64, max_delay=0.01, counters=counters)
    lane = broker.lane(cached)
    rng = np.random.default_rng(1)
    asks = [rng.choice(600, size=100, replace=False) for _ in range(8)]
    threads = [threading.Thread(target=lane.request, args=(a,))
               for a in asks]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    union = set(int(i) for a in asks for i in a)
    assert inner.calls == len(union)
    assert inner.queried == union
    snap = counters.snapshot()
    assert snap["counters"]["oracle_flushes"] < 8 * 100
    assert snap["counters"]["oracle_docs_flushed"] == len(union)
    occ = snap["observations"]["oracle_batch_occupancy"]
    assert occ["mean"] >= 1.0
    assert occ["max"] >= 64


def test_broker_handle_charges_per_session():
    truth = np.ones(100, bool)
    cached = CachedOracle(SimulatedOracle(truth))
    broker = OracleBroker(max_batch=8, max_delay=0.001)
    h1 = broker.wrap_for()(cached)
    h2 = broker.wrap_for()(cached)
    np.testing.assert_array_equal(h1.label(np.arange(40)), truth[:40])
    np.testing.assert_array_equal(h2.label(np.arange(20, 60)),
                                  truth[20:60])
    assert h1.calls == 40
    assert h2.calls == 20
    assert cached.calls == 60
    wrap = broker.wrap_for()
    assert wrap(cached) is wrap(cached)
    with pytest.raises(ValueError):
        OracleBroker(max_batch=0)


def test_broker_flush_on_deadline_without_filling():
    cached = CachedOracle(SimulatedOracle(np.ones(10, bool)))
    broker = OracleBroker(max_batch=1000, max_delay=0.005)
    t0 = time.perf_counter()
    out = broker.wrap_for()(cached).label([1, 2, 3])
    assert (time.perf_counter() - t0) < 2.0
    np.testing.assert_array_equal(out, [True] * 3)
    assert cached.purchases == 1


def test_broker_propagates_oracle_errors():
    class Boom:
        calls = 0

        def label(self, idx):
            raise RuntimeError("oracle down")

    broker = OracleBroker(max_batch=4, max_delay=0.001)
    handle = broker.wrap_for()(CachedOracle(Boom()))
    with pytest.raises(OracleUnavailable) as info:
        handle.label([0, 1, 2, 3])
    assert "oracle down" in str(info.value.__cause__)
    assert sorted(info.value.docs) == [0, 1, 2, 3]


def test_broker_isolates_failures_per_waiter():
    class Flaky:
        calls = 0
        fail = True

        def __init__(self, truth):
            self._truth = np.asarray(truth, bool)

        def label(self, idx):
            if self.fail:
                raise RuntimeError("transient lane fault")
            idx = np.asarray(idx, np.int64)
            self.calls += len(idx)
            return self._truth[idx]

    truth = np.arange(16) % 2 == 0
    flaky = Flaky(truth)
    cached = CachedOracle(flaky)
    broker = OracleBroker(max_batch=16, max_delay=0.05)
    h1, h2 = broker.wrap_for()(cached), broker.wrap_for()(cached)
    errors, lock = [], threading.Lock()

    def ask(handle, idx):
        try:
            handle.label(idx)
        except OracleUnavailable as exc:
            with lock:
                errors.append(exc)

    threads = [threading.Thread(target=ask, args=(h1, [0, 1, 2, 3])),
               threading.Thread(target=ask, args=(h2, [2, 3, 4, 5]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(errors) == 2
    assert errors[0] is not errors[1]
    for exc in errors:
        assert isinstance(exc.__cause__, RuntimeError)
        assert "transient lane fault" in str(exc.__cause__)
    assert not broker.lane(cached)._pending
    flaky.fail = False
    np.testing.assert_array_equal(h1.label([0, 1, 2, 3]), truth[:4])
    assert broker.counters.snapshot()["counters"]["oracle_asks_failed"] >= 1


# -- (a) server lifecycle ----------------------------------------------------

class _SlowOracle:
    """Deterministic oracle with a fixed per-invocation latency."""

    def __init__(self, truth, delay=0.05):
        self._truth = np.asarray(truth, bool)
        self.delay = delay
        self.calls = 0

    def label(self, indices):
        time.sleep(self.delay)
        indices = np.asarray(indices, np.int64)
        self.calls += len(indices)
        return self._truth[indices]


def test_server_backpressure_and_blocking_submit(corpus, cfgs):
    q = make_query(corpus, 7, selectivity=0.3)
    server = PredicateServer(_engine(corpus, cfgs), workers=1,
                             queue_depth=1)
    try:
        slow = [SemanticPredicate(q.embed, _SlowOracle(q.truth),
                                  name=f"slow{i}") for i in range(8)]
        admitted = []
        with pytest.raises(ServerSaturated):
            for i, pred in enumerate(slow):      # 1 running + 1 queued max
                admitted.append(server.submit(pred, seed=i))
        assert 1 <= len(admitted) < len(slow)
        snap = server.metrics_snapshot()
        assert snap["counters"]["sessions_rejected"] >= 1
        blocked = server.submit(slow[-1], seed=99, block=True, timeout=120)
        for s in admitted + [blocked]:
            s.result(timeout=300)
    finally:
        server.shutdown()


def test_session_states_deltas_and_stats(corpus, cfgs):
    q1 = make_query(corpus, 31, selectivity=0.3)
    q2 = make_query(corpus, 33, selectivity=0.4)
    pred = (SemanticPredicate(q1.embed, SimulatedOracle(q1.truth), name="a")
            & ~SemanticPredicate(q2.embed, SimulatedOracle(q2.truth),
                                 name="b"))
    with PredicateServer(_engine(corpus, cfgs), workers=2) as server:
        session = server.submit(pred, seed=0)
        deltas = list(session.iter_deltas(timeout=300))
        res = session.result(timeout=300)
    assert deltas[-1].final and [d.seq for d in deltas] == \
        list(range(len(deltas)))
    accepted = np.concatenate([d.accepted for d in deltas])
    rejected = np.concatenate([d.rejected for d in deltas])
    np.testing.assert_array_equal(np.sort(accepted),
                                  np.nonzero(res.mask)[0])
    np.testing.assert_array_equal(np.sort(rejected),
                                  np.nonzero(~res.mask)[0])
    stats = session.stats()
    seen_states = [s for s, _ in stats["states"]]
    assert seen_states[0] == "queued" and seen_states[-1] == "done"
    assert "training" in seen_states and "scoring" in seen_states
    assert stats["accepted"] + stats["rejected"] == N_DOCS
    assert stats["wall_seconds"] > 0


def test_failed_session_reports_and_server_survives(corpus, cfgs):
    class BadOracle:
        calls = 0

        def label(self, idx):
            raise ValueError("labeler exploded")

    q = make_query(corpus, 7, selectivity=0.3)
    with PredicateServer(_engine(corpus, cfgs), workers=1) as server:
        bad = server.submit(SemanticPredicate(q.embed, BadOracle()), seed=0)
        with pytest.raises(OracleUnavailable) as info:
            bad.result(timeout=300)
        assert isinstance(info.value.__cause__, ValueError)
        assert "labeler exploded" in str(info.value.__cause__)
        assert bad.state == SessionState.FAILED
        good = server.submit(
            SemanticPredicate(q.embed, SimulatedOracle(q.truth)), seed=0)
        assert good.result(timeout=300).mask.shape == (N_DOCS,)
        snap = server.metrics_snapshot()
        assert snap["counters"]["sessions_failed"] == 1
        assert snap["counters"]["sessions_done"] == 1


def test_submit_after_shutdown_raises(corpus, cfgs):
    server = PredicateServer(_engine(corpus, cfgs), workers=1)
    server.shutdown()
    assert server.closed
    q = make_query(corpus, 7, selectivity=0.3)
    with pytest.raises(ServerClosed):
        server.submit(SemanticPredicate(q.embed, SimulatedOracle(q.truth)))


def test_metrics_snapshot_is_json_serializable(corpus, cfgs):
    q = make_query(corpus, 7, selectivity=0.3)
    with PredicateServer(_engine(corpus, cfgs), workers=2) as server:
        server.run([SemanticPredicate(q.embed, SimulatedOracle(q.truth))],
                   seeds=[0])
        snap = server.metrics_snapshot()
        wire = server.metrics_json()
    parsed = json.loads(wire)
    for blob in (snap, parsed):
        assert blob["counters"]["sessions_done"] == 1
        assert "session_latency_seconds" in blob["observations"]
        assert "queue_depth" in blob["gauges"]
        assert blob["oracle_cache"]["docs_purchased"] > 0
    assert parsed["queue"]["capacity"] == 32


def test_standing_subscription_over_server(corpus, cfgs, tmp_path):
    """Full standing lifecycle through PredicateServer: refusal before
    enable_live(), session-shaped handle (shared id namespace, LIVE
    state, no result()), per-commit-group delta streaming off a pump,
    the metrics standing block, and cancel terminating the stream."""
    pcfg, ccfg = cfgs
    writer = StoreWriter.open(str(tmp_path), dim=DIM,
                              fingerprint={"model": "serve-live"})
    writer.append(corpus.embeds[:400])
    writer.commit()
    q = make_query(corpus, 41, selectivity=0.3)
    pred = SemanticPredicate(q.embed, SimulatedOracle(q.truth),
                             name="standing")
    engine = ScaleDocEngine(MemmapStore.open(str(tmp_path)), pcfg, ccfg,
                            chunk=128, device="cpu")
    with PredicateServer(engine, workers=2) as server:
        with pytest.raises(RuntimeError, match="disabled"):
            server.subscribe(pred, seed=3)
        server.enable_live(drift=DriftConfig(auto=False))
        session = server.subscribe(pred, seed=3, tenant="t")
        assert isinstance(session, StandingSession)
        assert session.state == StandingState.LIVE and not session.done()
        assert server.get_session(session.id) is session
        with pytest.raises(TypeError, match="no final result"):
            session.result()
        with pytest.raises(TypeError, match="no provenance"):
            server.explain(session.id)

        batches = []
        consumer = threading.Thread(
            target=lambda: batches.extend(session.iter_deltas(timeout=120)),
            daemon=True)
        consumer.start()

        writer.append(corpus.embeds[400:N_DOCS])
        writer.commit()
        writer.close()
        server.live.pump()
        snap = server.metrics_snapshot()
        assert snap["standing"] == {"subscribed": 1, "live": 1,
                                    "watermark": N_DOCS}
        assert snap["counters"]["standing_subscribed"] == 1
        stats = session.stats()
        assert stats["standing"] is True and stats["tenant"] == "t"
        assert stats["watermark"] == N_DOCS
        assert session.cancel()
        consumer.join(timeout=30)
        assert not consumer.is_alive()
    assert (batches[0].lo, batches[0].hi) == (400, N_DOCS)
    assert not batches[0].final and batches[-1].final
    assert session.state == StandingState.CANCELLED and session.done()


def test_shutdown_cancels_standing_sessions(corpus, cfgs):
    """Server shutdown pushes the final sentinel to every standing
    subscriber — streams terminate, nothing hangs."""
    q = make_query(corpus, 43, selectivity=0.3)
    server = PredicateServer(_engine(corpus, cfgs), workers=1)
    server.enable_live(drift=DriftConfig(auto=False))
    session = server.subscribe(
        SemanticPredicate(q.embed, SimulatedOracle(q.truth)), seed=1)
    server.shutdown()
    batches = list(session.iter_deltas(timeout=10))
    assert len(batches) == 1 and batches[0].final
    assert session.done()
    snap = server.metrics_snapshot()
    assert snap["standing"]["subscribed"] == 1
    assert snap["standing"]["live"] == 0


# -- (a) engine session views ------------------------------------------------

def test_session_view_isolates_decision_caches(corpus, cfgs):
    q = make_query(corpus, 7, selectivity=0.3)
    engine = _engine(corpus, cfgs)
    oracle = SimulatedOracle(q.truth)
    pred = SemanticPredicate(q.embed, oracle)
    view = engine.session_view()
    res1 = view.filter(pred, seed=0)
    assert view._proxies and not engine._proxies
    assert view._decisions and not engine._decisions
    calls = oracle.calls
    res2 = engine.session_view().filter(pred, seed=0)
    assert oracle.calls == calls
    np.testing.assert_array_equal(res1.mask, res2.mask)


def test_concurrent_filter_on_shared_engine_is_safe(corpus, cfgs):
    queries = [make_query(corpus, 60 + i, selectivity=0.3)
               for i in range(3)]
    engine = _engine(corpus, cfgs)
    out, errors = {}, []

    def work(i):
        try:
            q = queries[i]
            res = engine.filter(
                SemanticPredicate(q.embed, SimulatedOracle(q.truth),
                                  name=f"c{i}"), seed=i)
            out[i] = res.mask
        except BaseException as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors
    assert sorted(out) == [0, 1, 2]
    for mask in out.values():
        assert mask.dtype == bool and mask.shape == (N_DOCS,)


# -- (a) cross-query optimizer: shared-leaf CSE under concurrency -------------

def _shared_leaf_workload(corpus):
    """4-client workload over exactly TWO unique leaves."""
    qa = make_query(corpus, 150, selectivity=0.3)
    qb = make_query(corpus, 151, selectivity=0.4)
    sims = [SimulatedOracle(qa.truth), SimulatedOracle(qb.truth)]
    A = SemanticPredicate(qa.embed, CachedOracle(sims[0]), name="A")
    B = SemanticPredicate(qb.embed, CachedOracle(sims[1]), name="B")
    return sims, [A, B, A & ~B, A | B]


@pytest.fixture(scope="module")
def shared_leaf_serial(corpus, cfgs):
    sims, preds = _shared_leaf_workload(corpus)
    masks = [_engine(corpus, cfgs).filter(pred, seed=0).mask
             for pred in preds]
    return masks, sum(s.calls for s in sims)


@pytest.mark.parametrize("case", range(10))
def test_optimizer_concurrency_parity_and_single_training(
        corpus, cfgs, shared_leaf_serial, case):
    """Under 10 seeded thread interleavings of the shared-leaf workload,
    ``PredicateServer(optimize=True)`` reproduces the serial masks
    bitwise, trains each unique leaf's proxy once fleet-wide and buys no
    more labels than the serial runs."""
    serial_masks, serial_calls = shared_leaf_serial
    rng = np.random.default_rng(4000 + case)
    sims, preds = _shared_leaf_workload(corpus)
    with PredicateServer(_engine(corpus, cfgs), workers=4,
                         max_delay=0.003, optimize=True) as server:
        order = rng.permutation(len(preds))
        sessions = {}
        for i in order:
            sessions[i] = server.submit(preds[i], seed=0)
            time.sleep(float(rng.uniform(0.0, 0.02)))
        results = {i: s.result(timeout=300) for i, s in sessions.items()}
        snap = server.metrics_snapshot()
    for i, mask in enumerate(serial_masks):
        np.testing.assert_array_equal(
            mask, results[i].mask,
            err_msg=f"case {case}: query {i} diverged from serial")
    opt = snap["optimizer"]
    assert opt["enabled"] and opt["cse"]
    assert opt["proxies_trained"] == 2
    assert opt["artifact_hits"] + opt["flights_joined"] > 0
    assert sum(s.calls for s in sims) <= serial_calls


# -- (a) metrics sinks -------------------------------------------------------

def test_counter_set_and_jsonl_sink(tmp_path):
    counters = CounterSet()
    counters.inc("a")
    counters.gauge_delta("depth", 2)
    counters.gauge_delta("depth", -1)
    with counters.timer("t"):
        pass
    for v in range(1, 2001):
        counters.observe("lat", float(v))
    snap = counters.snapshot()
    assert snap["counters"] == {"a": 1.0}
    assert snap["gauges"]["depth"] == {"value": 1.0, "peak": 2.0}
    lat = snap["observations"]["lat"]
    assert lat["count"] == 2000 and lat["max"] == 2000.0
    assert 0 < lat["p50"] < lat["p95"] <= lat["p99"] <= 2000.0
    assert json.loads(counters.to_json())["counters"]["a"] == 1.0
    path = tmp_path / "m" / "log.jsonl"
    with Metrics(str(path), keep=2) as m:
        for step in range(3):
            m.log(step, loss=float(step))
        assert m.last()["loss"] == 2.0 and len(m.ring) == 2
    assert m.closed
    assert [json.loads(l)["step"] for l in path.read_text().splitlines()] \
        == [0, 1, 2]


def _fill(counters):
    counters.inc("sessions_done", 3)
    counters.inc("oracle-docs.flushed", 17)
    counters.gauge("queue_depth", 4)
    counters.gauge("queue_depth", 1)
    counters.gauge("9lives", float("inf"))
    for v in (0.5, 0.25, 2.0, 1.5):
        counters.observe("session_latency_seconds", v)
    counters.observe("nan_obs", float("nan"))


def test_render_prometheus_matches_the_reference():
    tc, jc = CounterSet(), JCounterSet()
    _fill(tc)
    _fill(jc)
    snap_t, snap_j = tc.snapshot(), jc.snapshot()
    text = render_prometheus(snap_t)
    assert text == j_render(snap_j)
    assert text == j_render(snap_t)
    assert "# TYPE scaledoc_sessions_done counter" in text
    assert "scaledoc_session_latency_seconds_count 4" in text
    assert "scaledoc__9lives +Inf" in text
    assert "charset=utf-8" in PROMETHEUS_CONTENT_TYPE
    # the reservoir summaries are the reference's, value for value
    assert snap_t["observations"]["session_latency_seconds"] == \
        snap_j["observations"]["session_latency_seconds"]


# -- (b) the JAX server against the port's ----------------------------------

def _with_params(engine, params):
    """Make every session view the server opens start from ``params``
    (leaf key -> proxy), as a cached proxy, so both packages score with
    the same proxies and train none."""
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


def test_mixed_workload_matches_the_jax_server(corpus, cfgs,
                                               jax_leaf_params):
    qs, params = jax_leaf_params
    j_sims = [JOracle(q.truth) for q in qs]
    t_sims = [SimulatedOracle(q.truth) for q in qs]
    jl = [JPred(q.embed, JCached(s), name=f"p{i}")
          for i, (q, s) in enumerate(zip(qs, j_sims))]
    tl = [SemanticPredicate(q.embed, CachedOracle(s), name=f"p{i}")
          for i, (q, s) in enumerate(zip(qs, t_sims))]
    forms = lambda p: [p[0], p[1] & ~p[2], p[3] | p[1], p[2]]
    je = _with_params(JEngine(JStore(corpus.embeds), JProxyCfg(**PROXY),
                              JCascadeCfg(accuracy_target=0.9)),
                      {a.key: p for a, p in zip(jl, params)})
    te = _with_params(_engine(corpus, cfgs),
                      {b.key: params_from_jax(p)
                       for b, p in zip(tl, params)})
    out = {}
    for name, server_cls, engine, leaves in (
            ("jax", JServer, je, jl), ("port", PredicateServer, te, tl)):
        with server_cls(engine, workers=4, max_delay=0.003) as server:
            sessions = [server.submit(p, seed=i)
                        for i, p in enumerate(forms(leaves))]
            out[name] = [s.result(timeout=300) for s in sessions]
            snap = server.metrics_snapshot()
        assert snap["counters"]["sessions_done"] == 4
    # which session pays for a label two sessions share depends on the
    # interleaving, so the per-session calls are compared only in sum
    for i, (a, b) in enumerate(zip(out["jax"], out["port"])):
        assert a.plan == b.plan, i
        np.testing.assert_array_equal(a.mask, b.mask, err_msg=f"query {i}")
        assert a.oracle_calls_train == b.oracle_calls_train == 0
    for a, b in zip(j_sims, t_sims):
        assert a.queried == b.queried
        assert a.calls == b.calls


def test_optimizer_trains_once_per_leaf_and_seed_in_both_packages(corpus,
                                                                   cfgs):
    """chip_smoke.py's serve shape (p1, p1 & ~p2 at seed 0, p2 | p3 at
    seed 1, p3 at seed 0) through PredicateServer(optimize=True): a proxy
    is shared per (leaf, seed), so both packages train five (p1@0, p2@0,
    p2@1, p3@1, p3@0), not one per leaf, and the masks are those of the
    same server without the optimizer."""
    qs = [make_query(corpus, 70 + i, selectivity=s)
          for i, s in enumerate((0.1, 0.2, 0.3))]
    shape = lambda p: [(p[0], 0), (p[0] & ~p[1], 0), (p[1] | p[2], 1),
                       (p[2], 0)]
    jax_p = [JPred(q.embed, JCached(JOracle(q.truth)), name=f"p{i + 1}")
             for i, q in enumerate(qs)]
    je = JEngine(JStore(corpus.embeds), JProxyCfg(**PROXY),
                 JCascadeCfg(accuracy_target=0.9))
    with JServer(je, workers=4, optimize=True) as server:
        for s in [server.submit(p, seed=sd) for p, sd in shape(jax_p)]:
            s.result(timeout=300)
        assert server.metrics_snapshot()["optimizer"][
            "proxies_trained"] == 5
    masks = {}
    for optimize in (False, True):
        p = [SemanticPredicate(q.embed, CachedOracle(SimulatedOracle(
            q.truth)), name=f"p{i + 1}") for i, q in enumerate(qs)]
        with PredicateServer(_engine(corpus, cfgs), workers=4,
                             optimize=optimize) as server:
            sessions = [server.submit(pr, seed=sd) for pr, sd in shape(p)]
            masks[optimize] = [s.result(timeout=300).mask for s in sessions]
            snap = server.metrics_snapshot()
        if optimize:
            assert snap["optimizer"]["proxies_trained"] == 5
    for a, b in zip(masks[False], masks[True]):
        np.testing.assert_array_equal(a, b)
