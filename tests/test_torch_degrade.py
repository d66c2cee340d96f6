"""The port's degraded modes (``degrade="defer" | "proxy_fallback"``) and
the repair queue, under an oracle plane that fails mid-filter.

(a) The JAX package's engine gates (tests/test_resilience.py, "engine
    degrade policies"), run on the port: zero faults are bit-transparent;
    defer, then repair after heal, is bitwise the fault-free run with no
    doc bought twice; a repair while the oracle is still down re-parks
    the ticket; proxy fallback decides everything. The breaker's cooldown
    passes on an injected clock, so no test waits on the wall clock.
(b) Parity: reference-trained params injected into both engines (as
    tests/test_torch_compound.py does), one seeded blackout in both
    packages' oracle stacks, for a leaf, a compound and a top-k, under
    defer and under proxy fallback. The unresolved sets, the partial and
    fallback masks, the parked tickets' fields, ``fallback_docs``, the
    calls, the provenance and the plan must be equal, and the accuracy
    debit agree to DEBIT_TOL. Stated preconditions (the scores agree to
    SCORE_TOL, not bitwise): no score lies within SCORE_TOL of a
    calibration bin edge (0.5, the untrained fallback cut, is one), and
    no score of a document the fallback decides lies within 2 SCORE_TOL
    of its leaf's quantile cut, unless it is the order statistic the cut
    falls on.
"""
import dataclasses

import numpy as np
import pytest

from repro.config.base import CascadeConfig as JCascadeCfg
from repro.config.base import ProxyConfig as JProxyCfg
from repro.core.oracle import CachedOracle as JCachedOracle
from repro.core.oracle import SimulatedOracle as JOracle
from repro.engine import InMemoryStore as JStore
from repro.engine import ScaleDocEngine as JEngine
from repro.engine import SemanticPredicate as JPred
from repro.engine import SemanticTopK as JTopK
from repro.serve import resilience as jres
from repro_torch.config import CascadeConfig, ProxyConfig
from repro_torch.core.encoder import params_from_jax
from repro_torch.core.oracle import CachedOracle, SimulatedOracle
from repro_torch.data import make_corpus, make_query
from repro_torch.engine import (InMemoryStore, RepairTicket, ScaleDocEngine,
                                SemanticPredicate, SemanticTopK)
from repro_torch.serve import (BreakerConfig, ChaosConfig, ChaosOracle,
                               ResilientOracle, RetryPolicy)
from test_torch_resilience import CountingOracle
from torch_threads import one_torch_thread  # noqa: F401

N_DOCS, DIM = 512, 32
SCORE_TOL = 1e-6
DEBIT_TOL = 1e-9
PROXY = dict(embed_dim=DIM, hidden_dim=32, latent_dim=16, proj_dim=8,
             phase1_steps=10, phase2_steps=10, batch_size=32)
TARGET = 0.85
FAST_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.0005,
                         max_delay_s=0.002, deadline_s=10.0)
FAST_BREAKER = BreakerConfig(failure_threshold=3, cooldown_s=0.05,
                             probe_retry_after_s=0.01)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(5, n_docs=N_DOCS, dim=DIM)


def _engine(corpus, **kw):
    return ScaleDocEngine(InMemoryStore(corpus.embeds), ProxyConfig(**PROXY),
                          CascadeConfig(accuracy_target=TARGET),
                          device="cpu", **kw)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _resilient(truth, chaos=None, clock=None):
    """(resilient, chaos_oracle, counting) stack over a SimulatedOracle;
    retries sleep through a no-op, the breaker reads ``clock``."""
    counting = CountingOracle(SimulatedOracle(truth))
    chaos_o = ChaosOracle(counting, chaos or ChaosConfig())
    res = ResilientOracle(CachedOracle(chaos_o), retry=FAST_RETRY,
                          breaker=FAST_BREAKER, clock=clock or Clock(),
                          sleep=lambda s: None)
    return res, chaos_o, counting


# -- the JAX package's gates, on the port ----------------------------------


def test_zero_faults_is_bit_transparent(corpus):
    """No injected faults: the full resilience stack produces the same
    mask, the same purchase counts, and zero policy activity."""
    q = make_query(corpus, 40, selectivity=0.3)
    plain = CachedOracle(SimulatedOracle(q.truth))
    base = _engine(corpus).filter(
        SemanticPredicate(q.embed, plain, name="p"), seed=4)
    res, chaos, counting = _resilient(q.truth)
    got = _engine(corpus).filter(
        SemanticPredicate(q.embed, res, name="p"), seed=4)
    np.testing.assert_array_equal(got.mask, base.mask)
    assert not got.degraded and got.error is None
    assert res.purchases == plain.purchases
    assert res.docs_purchased == plain.docs_purchased
    assert chaos.inner.calls == plain.calls
    stats = res.resilience_stats()
    assert all(stats[k] == 0 for k in ("retries", "bisects", "timeouts",
                                       "faults", "breaker_rejects",
                                       "gave_up_docs"))
    assert chaos.invocations == plain.purchases   # zero extra invocations


def test_engine_defer_then_repair_matches_fault_free_run(corpus):
    """A blackout mid-query defers the filter; after heal,
    repair_pending() replays it and the decisions are bitwise the
    fault-free run, with no doc ever purchased twice."""
    q = make_query(corpus, 41, selectivity=0.3)
    baseline = _engine(corpus).filter(
        SemanticPredicate(q.embed, CachedOracle(SimulatedOracle(q.truth)),
                          name="p"), seed=6)
    clock = Clock()
    res, chaos, counting = _resilient(q.truth, clock=clock)
    engine = _engine(corpus, degrade="defer")
    pred = SemanticPredicate(q.embed, res, name="p")
    # let a few invocations through, then pull the plug until heal
    chaos.chaos = ChaosConfig(blackouts=((2, 10_000),))
    degraded = engine.filter(pred, seed=6)
    assert degraded.degraded and degraded.degrade_mode == "defer"
    assert len(degraded.unresolved) > 0
    assert engine.repair_count == 1
    # UNKNOWN docs are excluded from the partial mask, not accepted
    assert not degraded.mask[degraded.unresolved].any()
    assert degraded.provenance.complete()

    chaos.heal()
    clock.t += FAST_BREAKER.cooldown_s + 0.02     # let the breaker probe
    repaired = engine.repair_pending()
    assert len(repaired) == 1 and engine.repair_count == 0
    healed = repaired[0]
    assert not healed.degraded
    np.testing.assert_array_equal(healed.mask, baseline.mask)
    assert all(v == 1 for v in counting.per_doc.values())


def test_repair_while_still_down_reparks(corpus):
    q = make_query(corpus, 42, selectivity=0.3)
    res, chaos, _ = _resilient(q.truth,
                               ChaosConfig(blackouts=((0, 10_000),)))
    engine = _engine(corpus, degrade="defer")
    pred = SemanticPredicate(q.embed, res, name="p")
    degraded = engine.filter(pred, seed=1, name="sticky")
    assert degraded.degraded and engine.repair_count == 1
    out = engine.repair_pending()            # oracle still dark
    assert out[0].degraded and engine.repair_count == 1   # re-parked
    # the caller's query name rides the ticket through re-park cycles
    ticket = engine.take_repairs()[0]
    assert isinstance(ticket, RepairTicket) and ticket.name == "sticky"
    engine.repark(ticket)
    assert engine.repair_count == 1


def test_engine_proxy_fallback_decides_everything(corpus):
    q = make_query(corpus, 43, selectivity=0.3)
    res, chaos, _ = _resilient(q.truth,
                               ChaosConfig(blackouts=((2, 10_000),)))
    engine = _engine(corpus)
    got = engine.filter(SemanticPredicate(q.embed, res, name="p"),
                        seed=2, degrade="proxy_fallback")
    assert got.degraded and got.degrade_mode == "proxy_fallback"
    assert got.fallback_docs > 0 and len(got.unresolved) == 0
    assert got.mask.dtype == bool and got.mask.shape == (N_DOCS,)
    assert 0.0 < got.est_accuracy_debit <= 1.0
    # proxy-only decisions still beat coin-flips on an easy query
    agree = float(np.mean(got.mask == q.truth))
    assert agree > 0.6


def test_query_reports_an_outage_before_the_leaf(corpus):
    """query() under defer, with the oracle dark from the first
    purchase: no leaf completed, and the degrade fields say so."""
    q = make_query(corpus, 44, selectivity=0.3)
    res = ResilientOracle(
        ChaosOracle(SimulatedOracle(q.truth),
                    ChaosConfig(blackouts=((0, 10_000),))),
        retry=FAST_RETRY, breaker=FAST_BREAKER, clock=Clock(),
        sleep=lambda s: None)
    st = _engine(corpus).query(q.embed, res, degrade="defer")
    assert st.degraded and st.degrade_mode == "defer"
    assert st.unresolved_docs == N_DOCS and st.fallback_docs == 0
    assert st.scores is None and not st.cascade.labels.any()


def test_unknown_degrade_policy_is_refused(corpus):
    with pytest.raises(ValueError, match="degrade"):
        _engine(corpus, degrade="retry")
    q = make_query(corpus, 45)
    with pytest.raises(ValueError, match="degrade"):
        _engine(corpus).filter(SemanticPredicate(
            q.embed, SimulatedOracle(q.truth)), degrade="ignore")


# -- parity with the JAX package under one seeded blackout -----------------


@pytest.fixture(scope="module")
def queries(corpus):
    return [make_query(corpus, 50 + j, selectivity=s)
            for j, s in enumerate((0.3, 0.4))]


@pytest.fixture(scope="module")
def jax_params(corpus, queries):
    """Each leaf trained once, in one run of the JAX engine."""
    je = JEngine(JStore(corpus.embeds), JProxyCfg(**PROXY),
                 JCascadeCfg(accuracy_target=TARGET))
    preds = [JPred(q.embed, JOracle(q.truth)) for q in queries]
    je.filter(preds[0] & preds[1], seed=0)
    return [je._proxies[p.key] for p in preds]


def _stack(pkg, truth, blackout):
    """Both packages' ResilientOracle(CachedOracle(ChaosOracle(
    SimulatedOracle))) under the same blackout window."""
    chaos_cfg = ChaosConfig(seed=0, blackouts=(blackout,))
    if pkg == "jax":
        chaos = jres.ChaosOracle(JOracle(truth), jres.ChaosConfig(
            **dataclasses.asdict(chaos_cfg)))
        return jres.ResilientOracle(
            JCachedOracle(chaos),
            retry=jres.RetryPolicy(**dataclasses.asdict(FAST_RETRY)),
            breaker=jres.BreakerConfig(**dataclasses.asdict(FAST_BREAKER)),
            clock=Clock(), sleep=lambda s: None)
    chaos = ChaosOracle(SimulatedOracle(truth), chaos_cfg)
    return ResilientOracle(CachedOracle(chaos), retry=FAST_RETRY,
                           breaker=FAST_BREAKER, clock=Clock(),
                           sleep=lambda s: None)


# name -> (build the predicate from leaves [a, b], blackout window per
# leaf oracle, top-k's k or None). Invocation 0 of a leaf's oracle buys
# its calibration sample (the params are injected, so nothing trains);
# a & ~b runs p2 -> p1, so p1's band fails after p2 completed; the
# top-k over p1 fails in its walk's second batch.
SCENARIOS = {
    "leaf": (lambda p: p[0], [(1, 10_000), None], None),
    "and_not": (lambda p: p[0] & ~p[1], [(1, 10_000), None], None),
    "topk_leaf": (lambda p: p[0], [(2, 10_000), None], 100),
    "topk_and_not": (lambda p: p[0] & ~p[1], [(1, 10_000), None], 20),
}


def _run(pkg, corpus, queries, jax_params, scenario, mode):
    build, blackouts, k = SCENARIOS[scenario]
    if pkg == "jax":
        eng = JEngine(JStore(corpus.embeds), JProxyCfg(**PROXY),
                      JCascadeCfg(accuracy_target=TARGET))
        pred_cls, topk_cls, oracle_cls = JPred, JTopK, JOracle
    else:
        eng = _engine(corpus)
        pred_cls, topk_cls, oracle_cls = (SemanticPredicate, SemanticTopK,
                                          SimulatedOracle)
    leaves = []
    for j, (q, bo) in enumerate(zip(queries, blackouts)):
        oracle = (oracle_cls(q.truth) if bo is None
                  else _stack(pkg, q.truth, bo))
        leaf = pred_cls(q.embed, oracle, name=f"p{j + 1}")
        eng._proxies[leaf.key] = (jax_params[j] if pkg == "jax"
                                  else params_from_jax(jax_params[j]))
        leaves.append(leaf)
    pred = build(leaves)
    if k is not None:
        pred = topk_cls(pred, k=k)
    res = eng.filter(pred, seed=0, degrade=mode, name=scenario)
    return eng, leaves, res


def _cut_gap(je, leaf, need):
    """How far the JAX engine's fallback scores of ``need`` lie from the
    quantile cut it places for ``leaf`` (the order statistic the cut
    falls on aside)."""
    params = je._proxies[leaf.key]
    s, _ = je.executor.score(params, leaf.e_q, je.store.get(need))
    alpha = je._selstats.get(leaf.key, measured_only=True)
    if alpha is None:
        alpha = je._cached_oracle(leaf.oracle).cached_positive_rate()
    if alpha is None or not 0.0 < alpha < 1.0 or len(need) <= 1:
        return np.abs(s - 0.5).min()
    d = np.abs(s - float(np.quantile(s, 1.0 - alpha)))
    return d[d > 0].min()


@pytest.mark.parametrize("mode", ["defer", "proxy_fallback"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_same_degraded_result_as_the_reference(corpus, queries, jax_params,
                                               scenario, mode):
    je, jl, rj = _run("jax", corpus, queries, jax_params, scenario, mode)
    te, tl, rt = _run("port", corpus, queries, jax_params, scenario, mode)
    assert rj.degraded and rj.degrade_mode == mode

    edges = np.linspace(0.0, 1.0, JCascadeCfg().num_bins + 1)
    for art in je._decisions.values():
        gap = np.abs(art.scores[:, None] - edges[None, :]).min()
        assert gap > SCORE_TOL, f"precondition: a score lies {gap:g} " \
            "from a calibration bin edge"
    if mode == "proxy_fallback" and not scenario.startswith("topk"):
        prov = rj.provenance
        for leaf in jl:
            if leaf.name not in prov.leaf_names:
                continue
            order_pos = prov.leaf_names.index(leaf.name)
            need = np.nonzero((prov.class_of == 5)
                              & (prov.leaf_of == order_pos))[0]
            if len(need):
                assert _cut_gap(je, leaf, need) > 2 * SCORE_TOL, \
                    "precondition: a fallback score lies at its cut"

    assert rt.plan == rj.plan
    np.testing.assert_array_equal(rt.mask, rj.mask)
    np.testing.assert_array_equal(rt.unresolved, rj.unresolved)
    assert (rt.degraded, rt.degrade_mode, rt.error, rt.fallback_docs) == \
        (rj.degraded, rj.degrade_mode, rj.error, rj.fallback_docs)
    assert abs(rt.est_accuracy_debit - rj.est_accuracy_debit) <= DEBIT_TOL
    assert (rt.oracle_calls_total, rt.oracle_calls_train) == \
        (rj.oracle_calls_total, rj.oracle_calls_train)
    np.testing.assert_array_equal(rt.provenance.class_of,
                                  rj.provenance.class_of)
    np.testing.assert_array_equal(rt.provenance.leaf_of,
                                  rj.provenance.leaf_of)
    assert rt.provenance.complete()
    for a, b in zip(rj.leaf_reports, rt.leaf_reports):
        np.testing.assert_array_equal(b.pending, a.pending)
        np.testing.assert_array_equal(b.labels, a.labels)
    assert len(rt.leaf_reports) == len(rj.leaf_reports)
    if mode == "defer":
        assert len(rj.unresolved) > 0
        assert not rt.mask[rt.unresolved].any()
        (tj,), (tt,) = je.take_repairs(), te.take_repairs()
        assert (tt.accuracy_target, tt.seed, tt.error, tt.name) == \
            (tj.accuracy_target, tj.seed, tj.error, tj.name)
        np.testing.assert_array_equal(tt.unresolved, tj.unresolved)
        assert type(tt.predicate).__name__ == type(tj.predicate).__name__
    else:
        assert len(rt.unresolved) == 0 and rt.fallback_docs > 0
        assert te.repair_count == je.repair_count == 0
