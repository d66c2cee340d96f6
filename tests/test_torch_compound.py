"""Port parity of compound filter() (the cost-ordered planner, collect-
then-batch training, lazy leaf resolution, decision provenance) and of
cross-session CSE against the JAX package's ScaleDocEngine.

(a) Reference-trained params injected into both engines' proxy caches:
    for ``p1 & ~p2``, ``p1 | p2`` and ``(p1 & p2) | ~p3`` the plans, the
    per-leaf pending sets, labels and oracle calls, the masks and the
    provenance maps must be equal, and the scores agree to SCORE_TOL.
    The plan follows either the planning pass's estimates (the trained
    proxies' share of scores above 0.5) or measured selectivities held
    in a QueryOptimizer's stats. Stated preconditions, as in
    test_torch_engine.py: no score lies within SCORE_TOL of a
    calibration bin edge (0.5, the planner's cut, is one), and the keys
    an AND/OR node sorts its children by either tie exactly in both
    packages or differ by more than PLAN_GAP, so SCORE_TOL cannot
    reorder a plan.
(b) The port's own invariants on the CPU: batched and per-leaf training
    give bitwise equal params and decisions, and the generative harness
    of tests/test_optimizer.py (random compound ASTs over four sessions)
    gives bitwise equal masks through ``QueryOptimizer()`` and through
    ``QueryOptimizer(cse=False)``, each unique leaf trained once.
"""
import numpy as np
import pytest
import torch

from repro.config.base import CascadeConfig as JCascadeCfg
from repro.config.base import ProxyConfig as JProxyCfg
from repro.core.oracle import SimulatedOracle as JOracle
from repro.engine import InMemoryStore as JStore
from repro.engine import ScaleDocEngine as JEngine
from repro.engine import SemanticPredicate as JPred
from repro.engine.executor import ScoringStats as JStats
from repro.engine.predicate import _NaryOp as JNaryOp
from repro_torch.config import CascadeConfig, ProxyConfig
from repro_torch.core.encoder import params_from_jax
from repro_torch.core.pipeline import ScaleDocPipeline
from repro_torch.data import make_corpus, make_query
from repro_torch.engine import (InMemoryStore, QueryOptimizer,
                                ScaleDocEngine, ScoringStats,
                                SemanticPredicate, SemanticTopK,
                                SimulatedOracle)

TARGET = 0.9
SCORE_TOL = 1e-6
PLAN_GAP = 1e-5
PROXY = dict(embed_dim=32, hidden_dim=64, latent_dim=32, proj_dim=16,
             phase1_steps=20, phase2_steps=20, batch_size=64)
SELS = (0.3, 0.4, 0.25)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(0, n_docs=1500, dim=32)


@pytest.fixture(scope="module")
def queries(corpus):
    return [make_query(corpus, 40 + j, selectivity=s)
            for j, s in enumerate(SELS)]


@pytest.fixture(scope="module")
def jax_params(corpus, queries):
    """Each leaf trained once, in one run of the JAX engine."""
    je = JEngine(JStore(corpus.embeds), JProxyCfg(**PROXY),
                 JCascadeCfg(accuracy_target=TARGET))
    preds = [JPred(q.embed, JOracle(q.truth)) for q in queries]
    je.filter(preds[0] & preds[1] & preds[2], seed=0)
    return [je._proxies[p.key] for p in preds]


def _pair(corpus, queries, jax_params, measured):
    """Both engines with the reference params injected, and each
    package's leaves p1, p2, p3 over fresh oracles. ``measured``
    attaches a QueryOptimizer to each engine whose stats hold every
    leaf's true selectivity as measured, so the plan follows those."""
    opts = ({}, {})
    if measured:
        from repro.engine import QueryOptimizer as JQueryOptimizer
        opts = ({"optimizer": JQueryOptimizer()},
                {"optimizer": QueryOptimizer()})
    je = JEngine(JStore(corpus.embeds), JProxyCfg(**PROXY),
                 JCascadeCfg(accuracy_target=TARGET), **opts[0])
    te = ScaleDocEngine(InMemoryStore(corpus.embeds), ProxyConfig(**PROXY),
                        CascadeConfig(accuracy_target=TARGET), device="cpu",
                        **opts[1])
    jl = [JPred(q.embed, JOracle(q.truth), name=f"p{j + 1}")
          for j, q in enumerate(queries)]
    tl = [SemanticPredicate(q.embed, SimulatedOracle(q.truth),
                            name=f"p{j + 1}") for j, q in enumerate(queries)]
    for a, b, params, q in zip(jl, tl, jax_params, queries):
        assert a.key.split(":")[0] == b.key.split(":")[0]
        je._proxies[a.key] = params
        te._proxies[b.key] = params_from_jax(params)
        if measured:
            je._selstats.observe(a.key, q.selectivity, measured=True)
            te._selstats.observe(b.key, q.selectivity, measured=True)
    return je, te, jl, tl


FORMS = {"and_not": lambda p: p[0] & ~p[1],
         "or": lambda p: p[0] | p[1],
         "nested": lambda p: (p[0] & p[1]) | ~p[2]}


def _nodes(pred):
    yield pred
    children = getattr(pred, "children", None) or (
        [pred.child] if hasattr(pred, "child") else [])
    for child in children:
        yield from _nodes(child)


@pytest.mark.parametrize("planning", ["estimated", "measured"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_injected_params_give_the_reference_compound(corpus, queries,
                                                     jax_params, form,
                                                     planning):
    measured = planning == "measured"
    je, te, jl, tl = _pair(corpus, queries, jax_params, measured)
    jpred = FORMS[form](jl)
    n_leaves = len(jpred.leaves())

    # the planning pass (or the measured stats): equal selectivities in
    # both packages, and the keys each AND/OR node sorts its children by
    # either tie exactly (the stable sort keeps the written order in both)
    # or differ by more than PLAN_GAP
    est_j = je._estimate_selectivities(jl[:n_leaves], JStats())
    est_t = te._estimate_selectivities(tl[:n_leaves], ScoringStats())
    for a, b in zip(jl[:n_leaves], tl):
        assert abs(est_t[b.key] - est_j[a.key]) <= 1e-12
    for node in _nodes(jpred):
        if isinstance(node, JNaryOp):
            keys = np.sort([c.plan(est_j)[1] for c in node.children])
            gaps = np.diff(keys)
            assert ((gaps == 0) | (gaps > PLAN_GAP)).all(), \
                f"precondition: plan keys {gaps} apart"

    je, te, jl, tl = _pair(corpus, queries, jax_params, measured)
    truth = FORMS[form]([q.truth for q in queries])
    rj = je.filter(FORMS[form](jl), ground_truth=truth, seed=0)
    rt = te.filter(FORMS[form](tl), ground_truth=truth, seed=0)

    edges = np.linspace(0.0, 1.0, JCascadeCfg().num_bins + 1)
    for art in je._decisions.values():
        gap = np.abs(art.scores[:, None] - edges[None, :]).min()
        assert gap > SCORE_TOL, f"precondition: a score lies {gap:g} " \
            "from a calibration bin edge"

    assert rt.plan == rj.plan
    assert len(rt.leaf_reports) == len(rj.leaf_reports) == n_leaves
    for a, b in zip(rj.leaf_reports, rt.leaf_reports):
        assert b.name == a.name
        np.testing.assert_array_equal(b.pending, a.pending)
        np.testing.assert_array_equal(b.labels, a.labels)
        np.testing.assert_array_equal(b.mech, a.mech)
        assert np.abs(b.scores - a.scores).max() <= SCORE_TOL
        assert (b.oracle_calls_train, b.oracle_calls_calib,
                b.oracle_calls_online, b.oracle_docs_charged) == \
            (a.oracle_calls_train, a.oracle_calls_calib,
             a.oracle_calls_online, a.oracle_docs_charged)
    np.testing.assert_array_equal(rt.mask, rj.mask)
    assert (rt.oracle_calls_total, rt.oracle_calls_train) == \
        (rj.oracle_calls_total, rj.oracle_calls_train)
    assert rt.data_reduction == rj.data_reduction
    assert rt.achieved_f1 == rj.achieved_f1
    np.testing.assert_array_equal(rt.provenance.class_of,
                                  rj.provenance.class_of)
    np.testing.assert_array_equal(rt.provenance.leaf_of,
                                  rj.provenance.leaf_of)
    assert rt.provenance.leaf_names == rj.provenance.leaf_names
    assert rt.provenance.complete()
    assert rt.provenance.to_payload(rt.mask) == \
        rj.provenance.to_payload(rj.mask)
    assert rt.scoring_stats.paths == ("fused",)


# -- the port's own invariants --------------------------------------------

def _params_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_params_equal(a[k], b[k])
                                            for k in a)
    return torch.equal(a, b)


def test_batched_leaf_training_matches_per_leaf(corpus):
    """One padded run for both leaves (batch_training=True) and one run
    a leaf (False) train bitwise equal params, hence equal decisions."""
    q1 = make_query(corpus, 21, selectivity=0.3)
    q2 = make_query(corpus, 23, selectivity=0.4)
    truth = q1.truth & ~q2.truth
    results, proxies = [], []
    for batched in (True, False):
        o1, o2 = SimulatedOracle(q1.truth), SimulatedOracle(q2.truth)
        engine = ScaleDocEngine(InMemoryStore(corpus.embeds),
                                ProxyConfig(**PROXY),
                                CascadeConfig(accuracy_target=TARGET),
                                batch_training=batched, device="cpu")
        pred = (SemanticPredicate(q1.embed, o1, name="p1")
                & ~SemanticPredicate(q2.embed, o2, name="p2"))
        results.append(engine.filter(pred, ground_truth=truth, seed=0))
        proxies.append([engine._proxies[lf.key] for lf in pred.leaves()])
    batched_res, seq_res = results
    for a, b in zip(*proxies):
        assert _params_equal(a, b)
    np.testing.assert_array_equal(batched_res.mask, seq_res.mask)
    assert batched_res.oracle_calls_total == seq_res.oracle_calls_total
    assert batched_res.oracle_calls_train == seq_res.oracle_calls_train
    assert batched_res.plan == seq_res.plan
    for rb, rs in zip(batched_res.leaf_reports, seq_res.leaf_reports):
        np.testing.assert_array_equal(rb.pending, rs.pending)
        np.testing.assert_array_equal(rb.scores, rs.scores)


def test_compound_equals_kleene_of_single_leaf_runs(corpus):
    """Canonical evaluation: a leaf's decisions do not depend on its plan
    position or its sibling lanes, so p1 & ~p2 is the Kleene combination
    of p1 and p2 filtered alone (each trained beside three dummies)."""
    q1 = make_query(corpus, 31, selectivity=0.3)
    q2 = make_query(corpus, 33, selectivity=0.35)

    def engine():
        return ScaleDocEngine(InMemoryStore(corpus.embeds),
                              ProxyConfig(**PROXY),
                              CascadeConfig(accuracy_target=TARGET),
                              device="cpu")

    def leaves():
        return [SemanticPredicate(q.embed, SimulatedOracle(q.truth),
                                  name=f"p{j + 1}")
                for j, q in enumerate((q1, q2))]

    p = leaves()
    co = engine()
    res = co.filter(p[0] & ~p[1], seed=0)
    solo, alone = leaves(), engine()
    singles = [alone.filter(lf, seed=0) for lf in solo]
    np.testing.assert_array_equal(res.mask,
                                  singles[0].mask & ~singles[1].mask)
    for a, b in zip(p, solo):
        assert _params_equal(co._proxies[a.key], alone._proxies[b.key])
    assert res.oracle_calls_total <= sum(r.oracle_calls_total
                                         for r in singles)


def _rand_shape(rng, n_leaves, depth):
    if depth <= 0 or rng.random() < 0.35:
        return ("leaf", int(rng.integers(n_leaves)))
    r = float(rng.random())
    if r < 0.25:
        return ("not", _rand_shape(rng, n_leaves, depth - 1))
    return ("and" if r < 0.65 else "or",
            _rand_shape(rng, n_leaves, depth - 1),
            _rand_shape(rng, n_leaves, depth - 1))


def _instantiate(shape, leaves):
    op = shape[0]
    if op == "leaf":
        return leaves[shape[1]]
    if op == "not":
        return ~_instantiate(shape[1], leaves)
    a, b = _instantiate(shape[1], leaves), _instantiate(shape[2], leaves)
    return a & b if op == "and" else a | b


def _leaf_indices(shape):
    if shape[0] == "leaf":
        return {shape[1]}
    return set().union(*(_leaf_indices(s) for s in shape[1:]))


OPT_PROXY = dict(embed_dim=32, hidden_dim=64, latent_dim=32, proj_dim=16,
                 phase1_steps=40, phase2_steps=40)


@pytest.fixture(scope="module")
def opt_corpus():
    return make_corpus(11, n_docs=600, dim=32)


def _opt_engine(corpus):
    return ScaleDocEngine(InMemoryStore(corpus.embeds),
                          ProxyConfig(**OPT_PROXY),
                          CascadeConfig(accuracy_target=TARGET), device="cpu")


@pytest.mark.parametrize("scenario", range(3))
def test_generative_plan_equivalence(opt_corpus, scenario):
    """tests/test_optimizer.py's harness on the port: four sessions of
    seeded random compound ASTs (depth <= 4) with forced shared-leaf
    overlap, through a shared QueryOptimizer() and through the cse=False
    arm. Per-session masks bitwise equal; the CSE arm buys no more labels
    and trains each unique leaf once."""
    rng = np.random.default_rng(7000 + scenario)
    sels = (0.2, 0.35, 0.5)
    qs = [make_query(opt_corpus, 100 * (scenario + 1) + j, selectivity=s)
          for j, s in enumerate(sels)]
    shapes = [_rand_shape(rng, len(qs), 3) for _ in range(4)]
    shared = int(rng.integers(len(qs)))
    shapes[2] = ("and", ("leaf", shared), shapes[2])
    shapes[3] = ("or", ("leaf", shared), shapes[3])
    used = sorted(set().union(*map(_leaf_indices, shapes)))

    def run_arm(cse):
        leaves = [SemanticPredicate(q.embed, SimulatedOracle(q.truth),
                                    name=f"L{j}")
                  for j, q in enumerate(qs)]
        engine = _opt_engine(opt_corpus)
        opt = QueryOptimizer(cse=cse)
        masks = []
        for shape in shapes:
            view = engine.session_view(optimizer=opt)
            res = view.filter(_instantiate(shape, leaves), seed=0)
            assert res.provenance.complete()
            masks.append(res.mask.copy())
        return masks, sum(lf.oracle.calls for lf in leaves), opt

    on_masks, on_calls, opt_on = run_arm(True)
    off_masks, off_calls, opt_off = run_arm(False)
    for m_on, m_off in zip(on_masks, off_masks):
        np.testing.assert_array_equal(m_on, m_off)
    assert on_calls <= off_calls
    assert opt_on.proxies_trained == len(used)
    assert opt_off.proxies_trained > opt_on.proxies_trained
    assert opt_on.artifact_hits + opt_on.proxy_hits > 0


def test_measured_stats_order_the_plan(opt_corpus):
    """Measured selectivities in the shared stats override the per-
    session cosine heuristic: AND runs the most selective leaf first, OR
    the least selective."""
    qa = make_query(opt_corpus, 60, selectivity=0.4)
    qb = make_query(opt_corpus, 61, selectivity=0.4)
    A = SemanticPredicate(qa.embed, SimulatedOracle(qa.truth), name="A")
    B = SemanticPredicate(qb.embed, SimulatedOracle(qb.truth), name="B")
    engine = _opt_engine(opt_corpus)
    opt = QueryOptimizer()
    opt.stats.observe(A.key, 0.9, measured=True)
    opt.stats.observe(B.key, 0.1, measured=True)
    res = engine.session_view(optimizer=opt).filter(A & B, seed=0)
    assert res.plan.split(" -> ")[0] == "B"
    res_or = engine.session_view(optimizer=opt).filter(A | B, seed=1)
    assert res_or.plan.split(" -> ")[0] == "A"


def test_filter_publishes_measured_selectivity(opt_corpus):
    q = make_query(opt_corpus, 62, selectivity=0.3)
    leaf = SemanticPredicate(q.embed, SimulatedOracle(q.truth), name="L")
    opt = QueryOptimizer()
    _opt_engine(opt_corpus).session_view(optimizer=opt).filter(leaf, seed=0)
    assert opt.stats.level(leaf.key) == "measured"
    got = opt.stats.get(leaf.key, measured_only=True)
    assert got is not None and 0.0 <= got <= 1.0
    sel = opt.snapshot()["selectivity"]
    assert sel["measured"] >= 1
    assert sel["entries"][leaf.key]["name"] == "L"


def test_session_views_share_labels_and_clear_caches(opt_corpus):
    """Views share the label caches, not the proxy/decision caches; an
    observer sees every phase; clear_caches drops all of it."""
    q = make_query(opt_corpus, 63, selectivity=0.3)
    oracle = SimulatedOracle(q.truth)
    engine = _opt_engine(opt_corpus)
    phases = []

    class Obs:
        def on_phase(self, name):
            phases.append(name)

        def on_partial(self, accepted, rejected):
            phases.append(("partial", len(accepted) + len(rejected)))

    first = engine.session_view(observer=Obs()).filter(
        SemanticPredicate(q.embed, oracle), seed=0)
    assert phases == ["planning", "training", "scoring",
                      ("partial", len(opt_corpus.embeds)), "done"]
    assert not engine._proxies and engine._oracles   # view-local proxies
    calls = oracle.calls
    again = engine.session_view().filter(SemanticPredicate(q.embed, oracle),
                                         seed=0)
    assert oracle.calls == calls            # every label already cached
    np.testing.assert_array_equal(again.mask, first.mask)
    shared = engine.session_view(share_caches=True)
    shared.filter(SemanticPredicate(q.embed, oracle), seed=0)
    assert engine._proxies and engine._decisions
    engine.clear_caches()
    assert not (engine._proxies or engine._decisions or engine._oracles)
    engine.filter(SemanticPredicate(q.embed, oracle), seed=0)
    assert oracle.calls > calls             # labels really were re-bought


def test_pipeline_shim_is_the_engine_per_query(opt_corpus):
    q = make_query(opt_corpus, 64, selectivity=0.3)
    pipe = ScaleDocPipeline(opt_corpus.embeds, ProxyConfig(**OPT_PROXY),
                            CascadeConfig(accuracy_target=TARGET),
                            device="cpu")
    st = pipe.query(q.embed, SimulatedOracle(q.truth), ground_truth=q.truth)
    ref = _opt_engine(opt_corpus).query(q.embed, SimulatedOracle(q.truth),
                                        ground_truth=q.truth)
    np.testing.assert_array_equal(st.cascade.labels, ref.cascade.labels)
    assert st.oracle_calls_total == ref.oracle_calls_total
    assert pipe.proxy_cfg.embed_dim == opt_corpus.embeds.shape[1]


def test_what_stays_refused(opt_corpus):
    """Nothing of this path is refused any more: a session view takes a
    tracer (test_torch_trace.py), and top-k and the degrade policies,
    once refused here, run on a compound child and a compound
    predicate."""
    from repro_torch.runtime.trace import Tracer
    q = make_query(opt_corpus, 65)
    leaf = SemanticPredicate(q.embed, SimulatedOracle(q.truth))
    engine = _opt_engine(opt_corpus)
    tracer = Tracer()
    traced = engine.session_view(tracer=tracer).filter(leaf & ~leaf,
                                                       seed=0)
    assert not traced.mask.any()
    assert [s["name"] for s in tracer.spans()
            if s["parent_id"] is None] == ["engine.filter"]
    res = engine.session_view().filter(SemanticTopK(leaf | leaf, k=1),
                                       seed=0)
    assert res.plan.startswith("topk[k=1]: ") and res.mask.sum() <= 1
    deferred = engine.filter(leaf & ~leaf, degrade="defer", seed=0)
    assert not deferred.degraded and not deferred.mask.any()
    assert ScaleDocEngine(opt_corpus.embeds, degrade="proxy_fallback",
                          device="cpu").degrade == "proxy_fallback"
