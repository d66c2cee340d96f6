"""The port's observability plane (``repro_torch.runtime.trace``).

(a) The JAX package's tracer and cost-ledger tests (tests/test_trace.py)
    run on the port: traceparent propagation, ambient nesting, error
    annotation, explicit parents and links, the disabled no-op tracer,
    the flight-recorder ring, the Chrome-trace export, the ledger's
    attribution, one compound filter()'s rooted span tree with complete
    provenance, the tracing-off bitwise parity through a server, and
    explain()'s errors.
(b) Parity: one compound filter() on each package's engine, with the
    JAX-trained params injected into both, records a span tree with the
    same names, kinds and nesting (children in start order) and the same
    plan order, and both trace ids and span ids are W3C-shaped. The
    preconditions of tests/test_torch_compound.py hold for this corpus:
    the injected params give the planning pass equal estimates.
The HTTP propagation test (tests/test_trace.py::
test_http_propagation_e2e_four_clients) waits for the port's gateway.
"""
import numpy as np
import pytest

from repro.config.base import CascadeConfig as JCascadeCfg
from repro.config.base import ProxyConfig as JProxyCfg
from repro.core.oracle import SimulatedOracle as JOracle
from repro.engine import InMemoryStore as JStore
from repro.engine import ScaleDocEngine as JEngine
from repro.engine import SemanticPredicate as JPred
from repro.runtime.trace import Tracer as JTracer
from repro_torch.config import CascadeConfig, ProxyConfig
from repro_torch.core.encoder import params_from_jax
from repro_torch.core.oracle import CachedOracle, SimulatedOracle
from repro_torch.data import make_corpus, make_query
from repro_torch.engine import InMemoryStore, ScaleDocEngine, SemanticPredicate
from repro_torch.runtime import trace as trace_mod
from repro_torch.runtime.trace import (CostLedger, SpanContext, Tracer,
                                       make_traceparent, parse_traceparent,
                                       span_tree)
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


def _engine(corpus, cfgs):
    pcfg, ccfg = cfgs
    return ScaleDocEngine(InMemoryStore(corpus.embeds), pcfg, ccfg,
                          device="cpu")


def _workload(corpus):
    qs = [make_query(corpus, 100 + i, selectivity=0.3) for i in range(4)]
    sims = [SimulatedOracle(q.truth) for q in qs]
    cached = [CachedOracle(s) for s in sims]
    p = [SemanticPredicate(qs[i].embed, cached[i], name=f"p{i}")
         for i in range(4)]
    preds = [p[0], p[1] & ~p[2], p[3] | p[1], p[2]]
    oracles = {f"o{i}": cached[i] for i in range(4)}
    return oracles, preds


# -- (a) traceparent propagation ---------------------------------------------

def test_traceparent_roundtrip():
    ctx = SpanContext("ab" * 16, "cd" * 8)
    header = make_traceparent(ctx)
    assert header == f"00-{'ab' * 16}-{'cd' * 8}-01"
    back = parse_traceparent(header)
    assert back == ctx
    assert back.trace_id == ctx.trace_id
    assert back.span_id == ctx.span_id


@pytest.mark.parametrize("bad", [
    None, "", "garbage", "00-short-cdcdcdcdcdcdcdcd-01",
    "00-" + "gg" * 16 + "-" + "cd" * 8 + "-01",     # non-hex
    "00-" + "0" * 32 + "-" + "cd" * 8 + "-01",      # all-zero trace id
    "00-" + "ab" * 16 + "-" + "0" * 16 + "-01",     # all-zero span id
    "00-" + "ab" * 16 + "-" + "cd" * 8,             # 3 parts
    42,
])
def test_traceparent_malformed_degrades_to_none(bad):
    assert parse_traceparent(bad) is None


# -- (a) span tree mechanics --------------------------------------------------

def test_ambient_nesting_and_well_formedness():
    tracer = Tracer()
    with tracer.span("root", kind="test") as root:
        trace_mod.annotate(color="red")
        with tracer.span("child") as child:
            trace_mod.add_event("tick", n=1)
            assert trace_mod.current_span() is child
        with tracer.span("sibling"):
            pass
    assert trace_mod.current_span() is None     # stack fully popped
    spans = tracer.spans(root.ctx.trace_id)
    assert [s["name"] for s in spans] == ["child", "sibling", "root"]
    by_name = {s["name"]: s for s in spans}
    assert {s["trace_id"] for s in spans} == {root.ctx.trace_id}
    assert by_name["child"]["parent_id"] == root.ctx.span_id
    assert by_name["sibling"]["parent_id"] == root.ctx.span_id
    assert by_name["root"]["parent_id"] is None
    for s in spans:
        assert s["end"] >= s["start"] >= 0.0
        assert s["duration"] >= 0.0
    assert by_name["root"]["attrs"]["color"] == "red"
    assert by_name["child"]["events"][0]["name"] == "tick"
    assert by_name["child"]["events"][0]["attrs"] == {"n": 1}


def test_span_error_annotation():
    tracer = Tracer()
    with pytest.raises(ValueError):
        with tracer.span("boom") as span:
            raise ValueError("nope")
    rec = tracer.spans(span.ctx.trace_id)[0]
    assert "ValueError" in rec["attrs"]["error"]
    assert rec["end"] >= rec["start"]           # closed despite the raise


def test_explicit_parent_and_links():
    tracer = Tracer()
    remote = SpanContext("ef" * 16, "12" * 8)
    with tracer.span("server", parent=remote) as server:
        assert server.ctx.trace_id == remote.trace_id
    with tracer.span("flush", parent=None) as flush:
        flush.link(server.ctx)
        assert flush.ctx.trace_id != remote.trace_id   # own root
    rec = tracer.spans(flush.ctx.trace_id)[0]
    assert rec["links"] == [{"trace_id": server.ctx.trace_id,
                             "span_id": server.ctx.span_id}]


def test_disabled_tracer_is_noop():
    tracer = Tracer(enabled=False)
    with tracer.span("a") as a:
        with tracer.span("b") as b:
            assert a is b                       # one shared no-op span
            assert a.ctx is None
            a.set(x=1).event("e")               # all chainable no-ops
            trace_mod.annotate(y=2)             # ambient no-ops too
            trace_mod.add_event("z")
    snap = tracer.snapshot()
    assert snap["enabled"] is False
    assert snap["recorded"] == 0 and snap["spans"] == []
    with trace_mod.NULL_TRACER.span("c") as c:
        assert c.ctx is None


def test_flight_recorder_ring_bounds():
    tracer = Tracer(capacity=8)
    for i in range(20):
        with tracer.span(f"s{i}"):
            pass
    snap = tracer.snapshot()
    assert snap["recorded"] == 20
    assert snap["retained"] == 8
    assert snap["dropped"] == 12
    assert [s["name"] for s in snap["spans"]] == [
        f"s{i}" for i in range(12, 20)]
    tracer.reset()
    assert tracer.snapshot()["recorded"] == 0


def test_chrome_trace_export_shape():
    tracer = Tracer()
    with tracer.span("outer") as outer:
        with tracer.span("inner"):
            trace_mod.add_event("mark")
    doc = tracer.chrome_trace(outer.ctx.trace_id)
    assert set(doc) >= {"traceEvents", "displayTimeUnit"}
    events = doc["traceEvents"]
    assert {e["ph"] for e in events} == {"X", "i"}
    for e in events:
        if e["ph"] == "X":
            assert e["dur"] >= 0 and "ts" in e and "name" in e


# -- (a) cost ledger ---------------------------------------------------------

def test_cost_ledger_attribution_and_defaults():
    ledger = CostLedger()
    ledger.record_session(
        session_id="q-1", tenant=None, name="p0", trace_id="t" * 32,
        leaves=[{"leaf": "p0", "oracle_docs_train": 80,
                 "oracle_docs_calib": 30, "oracle_docs_online": 10,
                 "proxy_flops": 1e9, "reused": False,
                 "cse_saved_docs": 0}],
        wall_seconds=1.5, degraded=False)
    ledger.record_session(
        session_id="q-2", tenant="acme", name="p0", trace_id="u" * 32,
        leaves=[{"leaf": "p0", "oracle_docs_train": 0,
                 "oracle_docs_calib": 0, "oracle_docs_online": 5,
                 "proxy_flops": 0.0, "reused": True,
                 "cse_saved_docs": 80}],
        wall_seconds=0.5, degraded=True)
    snap = ledger.snapshot()
    public = snap["tenants"]["public"]          # tenant None -> "public"
    assert public["oracle_docs"] == 120
    assert public["oracle_docs_train"] == 80
    assert public["oracle_flops"] == pytest.approx(120 * 50e12)
    acme = snap["tenants"]["acme"]
    assert acme["oracle_docs"] == 5
    assert acme["cse_reuses"] == 1 and acme["cse_saved_docs"] == 80
    assert acme["cse_saved_flops"] == pytest.approx(80 * 50e12)
    assert acme["degraded_sessions"] == 1
    assert snap["leaves"]["p0"]["sessions"] == 2
    recent = snap["recent_sessions"]
    assert [r["session"] for r in recent] == ["q-1", "q-2"]
    assert ledger.tenant_totals(None)["sessions"] == 1
    assert ledger.tenant_totals("missing")["sessions"] == 0


def test_cost_ledger_retry_waste_charges_infra():
    ledger = CostLedger()
    ledger.record_retry_waste(40, retries=3)
    snap = ledger.snapshot()
    infra = snap["tenants"]["_infra"]
    assert infra["retry_waste_docs"] == 40
    assert snap["tenants"].keys() == {"_infra"}


# -- (a) engine level: span tree + provenance for one filter -----------------

def test_filter_emits_rooted_tree_and_complete_provenance(corpus, cfgs):
    oracles, preds = _workload(corpus)
    engine = _engine(corpus, cfgs)
    tracer = Tracer()
    view = engine.session_view(tracer=tracer)
    result = view.filter(preds[1], seed=1)       # compound: p1 & ~p2

    prov = result.provenance
    assert prov is not None and prov.complete()
    counts = prov.counts()
    assert sum(counts.values()) == result.n_docs == N_DOCS
    mask = np.asarray(result.mask, bool)
    assert np.all(mask[prov.class_of == trace_mod.PROXY_ACCEPT])
    assert not np.any(mask[prov.class_of == trace_mod.PROXY_REJECT])
    assert counts.get("oracle", 0) + counts.get("cached_label", 0) > 0

    spans = tracer.spans()
    assert spans, "filter recorded no spans"
    tid = spans[0]["trace_id"]
    assert {s["trace_id"] for s in spans} == {tid}
    roots = [s for s in spans if s["parent_id"] is None]
    assert [s["name"] for s in roots] == ["engine.filter"]
    ids = {s["span_id"] for s in spans}
    for s in spans:
        assert s["end"] >= s["start"]
        if s["parent_id"] is not None:
            assert s["parent_id"] in ids
    names = {s["name"] for s in spans}
    assert "plan" in names and "train" in names
    assert any(n.startswith("leaf:") for n in names)
    assert "score" in names and "decide" in names
    # the executor's per-pass accounting lands on the score span
    score = next(s for s in spans if s["name"] == "score")
    assert score["attrs"]["tiles"] >= 1 and score["attrs"]["docs"] == N_DOCS
    # the engine itself stayed untraced: tracing is per session view
    assert engine._tracer is trace_mod.NULL_TRACER

    charged = sum(r.oracle_docs_charged + r.oracle_calls_train
                  for r in result.leaf_reports)
    purchased = sum(o.stats()["docs_purchased"] for o in oracles.values())
    assert charged == purchased


def test_tracing_disabled_bitwise_parity(corpus, cfgs):
    """Tracing off must be decision-invariant: the same workload through
    a PredicateServer(trace=False) produces bitwise-identical masks, and
    records nothing."""
    oracles, preds = _workload(corpus)
    serial = [_engine(corpus, cfgs).filter(p, seed=i).mask
              for i, p in enumerate(preds)]

    oracles, preds = _workload(corpus)      # fresh oracles
    with PredicateServer(_engine(corpus, cfgs), workers=2,
                         trace=False) as server:
        sessions = [server.submit(p, seed=i)
                    for i, p in enumerate(preds)]
        masks = [s.result(timeout=300).mask for s in sessions]
        assert not server.tracer.enabled
        assert server.tracer.snapshot()["recorded"] == 0
        for s in sessions:
            assert s.trace_id is None
    for ref, got in zip(serial, masks):
        np.testing.assert_array_equal(ref, got)


def test_explain_errors(corpus, cfgs):
    oracles, preds = _workload(corpus)
    with PredicateServer(_engine(corpus, cfgs), workers=1) as server:
        with pytest.raises(KeyError):
            server.explain("nope")
        session = server.submit(preds[0], seed=0)
        session.result(timeout=300)
        payload = server.explain(session.id, include_docs=False)
        assert payload["complete"] is True and "class_of" not in payload
        assert payload["trace_id"] == session.trace_id


# -- (b) the span tree against the JAX package's ------------------------------

def _shape(nodes):
    """(name, kind, children) of a span tree, children in start order."""
    return [(n["span"]["name"], n["span"]["attrs"].get("kind"),
             _shape(n["children"])) for n in nodes]


@pytest.fixture(scope="module")
def injected(corpus):
    """Two leaves' params trained once by the JAX engine."""
    qs = [make_query(corpus, 40 + j, selectivity=s)
          for j, s in enumerate((0.3, 0.4))]
    je = JEngine(JStore(corpus.embeds), JProxyCfg(**PROXY),
                 JCascadeCfg(accuracy_target=0.9))
    jl = [JPred(q.embed, JOracle(q.truth)) for q in qs]
    je.filter(jl[0] & jl[1], seed=0)
    return qs, [je._proxies[p.key] for p in jl]


@pytest.mark.parametrize("form", ["and_not", "or"])
def test_span_tree_matches_the_reference(corpus, cfgs, injected, form):
    qs, params = injected
    build = {"and_not": lambda p: p[0] & ~p[1],
             "or": lambda p: p[0] | p[1]}[form]
    je = JEngine(JStore(corpus.embeds), JProxyCfg(**PROXY),
                 JCascadeCfg(accuracy_target=0.9))
    te = _engine(corpus, cfgs)
    jl = [JPred(q.embed, JOracle(q.truth), name=f"p{j + 1}")
          for j, q in enumerate(qs)]
    tl = [SemanticPredicate(q.embed, SimulatedOracle(q.truth),
                            name=f"p{j + 1}") for j, q in enumerate(qs)]
    for a, b, p in zip(jl, tl, params):
        je._proxies[a.key] = p
        te._proxies[b.key] = params_from_jax(p)
    jt, tt = JTracer(), Tracer()
    je._tracer = jt
    jres = je.filter(build(jl), seed=1)
    tres = te.session_view(tracer=tt, share_caches=True).filter(
        build(tl), seed=1)
    assert jres.plan == tres.plan
    np.testing.assert_array_equal(jres.mask, tres.mask)
    jtree, ttree = span_tree(jt.spans()), span_tree(tt.spans())
    assert _shape(ttree) == _shape(jtree)
    plan_order = lambda spans: next(s["attrs"]["order"] for s in spans
                                    if s["name"] == "plan")
    assert plan_order(tt.spans()) == plan_order(jt.spans())
    for s in tt.spans():
        assert len(s["trace_id"]) == 32 and len(s["span_id"]) == 16
