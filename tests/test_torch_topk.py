"""The port's ``SemanticTopK`` execution (the rank walk over canonical
leaf artifacts).

(a) The JAX package's four top-k tests (tests/test_optimizer.py,
    "SemanticTopK"), run on the port: composition and bad k are refused;
    the k members are accepts of the child's own filter() at the same
    seed and cost no more labels; k above the cardinality gives the
    filter mask; a compound child through a QueryOptimizer counts one
    top-k query.
(b) Parity: reference-trained params injected into both engines (as
    tests/test_torch_compound.py does). For ``SemanticTopK(leaf, k)`` at
    k = 10 (one batch of the walk) and k = 150 (several), for
    ``SemanticTopK(a & ~b, k)`` and for the direct-label route (a
    collection of at most DIRECT_LABEL_CUTOFF documents), the plan
    string, the documents walked, the accepted list in the order it was
    accepted, the per-leaf pending sets, labels and calls, the mask and
    the provenance (TOPK_SKIP included) must be equal, and the scores
    agree to SCORE_TOL. Stated preconditions: no score lies within
    SCORE_TOL of a calibration bin edge, and no two ranks in the walked
    prefix (and the first rank past it) lie within SCORE_TOL of each
    other, so the scores' rounding cannot reorder the walk.
"""
import numpy as np
import pytest

from repro.config.base import CascadeConfig as JCascadeCfg
from repro.config.base import ProxyConfig as JProxyCfg
from repro.core.oracle import SimulatedOracle as JOracle
from repro.engine import InMemoryStore as JStore
from repro.engine import ScaleDocEngine as JEngine
from repro.engine import SemanticPredicate as JPred
from repro.engine import SemanticTopK as JTopK
from repro_torch.config import CascadeConfig, ProxyConfig
from repro_torch.core.encoder import params_from_jax
from repro_torch.data import make_corpus, make_query
from repro_torch.engine import (InMemoryStore, QueryOptimizer,
                                ScaleDocEngine, SemanticPredicate,
                                SemanticTopK, SimulatedOracle)
from repro_torch.engine.engine import DIRECT_LABEL_CUTOFF
from repro_torch.runtime import trace as trace_mod
from torch_threads import one_torch_thread  # noqa: F401

N_DOCS, DIM = 600, 32
TARGET = 0.9
SCORE_TOL = 1e-6


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(11, n_docs=N_DOCS, dim=DIM)


def _engine(corpus):
    return ScaleDocEngine(
        InMemoryStore(corpus.embeds),
        ProxyConfig(embed_dim=DIM, hidden_dim=64, latent_dim=32,
                    proj_dim=16, phase1_steps=40, phase2_steps=40),
        CascadeConfig(accuracy_target=TARGET), device="cpu")


# -- the JAX package's top-k tests, on the port ----------------------------


def test_topk_rejects_composition_and_bad_k(corpus):
    q = make_query(corpus, 70, selectivity=0.3)
    leaf = SemanticPredicate(q.embed, SimulatedOracle(q.truth), name="p")
    tk = SemanticTopK(leaf, k=5)
    for bad in (lambda: tk & leaf, lambda: leaf | tk, lambda: ~tk,
                lambda: SemanticTopK(tk, k=3)):
        with pytest.raises(TypeError):
            bad()
    with pytest.raises(ValueError):
        SemanticTopK(leaf, k=0)
    with pytest.raises(TypeError):
        SemanticTopK(leaf, k=True)
    with pytest.raises(TypeError):
        SemanticTopK(leaf, k=2.5)


def test_topk_members_are_canonical_filter_accepts(corpus):
    """The k winners are accepted by an independent plain filter of the
    child at the same seed, and the rank walk stops early (no more
    labels than the full run)."""
    q = make_query(corpus, 70, selectivity=0.3)
    o_full = SimulatedOracle(q.truth)
    full = _engine(corpus).filter(
        SemanticPredicate(q.embed, o_full, name="p"), seed=0)
    o_topk = SimulatedOracle(q.truth)
    res = _engine(corpus).filter(
        SemanticTopK(SemanticPredicate(q.embed, o_topk, name="p"), k=10),
        seed=0)
    accepted = np.flatnonzero(res.mask)
    assert len(accepted) == 10           # plenty of positives exist
    assert full.mask[accepted].all()
    assert res.plan.startswith("topk[k=10]: ")
    assert o_topk.calls <= o_full.calls
    assert res.oracle_calls_total < N_DOCS
    assert res.provenance.complete()


def test_topk_with_k_above_cardinality_equals_filter(corpus):
    """k >= |accepted| walks every candidate: the result is the plain
    filter mask, bitwise."""
    q = make_query(corpus, 71, selectivity=0.25)
    full = _engine(corpus).filter(
        SemanticPredicate(q.embed, SimulatedOracle(q.truth), name="p"),
        seed=0)
    res = _engine(corpus).filter(
        SemanticTopK(SemanticPredicate(q.embed, SimulatedOracle(q.truth),
                                       name="p"), k=N_DOCS),
        seed=0)
    np.testing.assert_array_equal(res.mask, full.mask)


def test_topk_over_compound_child(corpus):
    qa = make_query(corpus, 72, selectivity=0.4)
    qb = make_query(corpus, 73, selectivity=0.4)
    pred = (SemanticPredicate(qa.embed, SimulatedOracle(qa.truth), name="a")
            & ~SemanticPredicate(qb.embed, SimulatedOracle(qb.truth),
                                 name="b"))
    full = _engine(corpus).filter(pred, seed=0)
    pred2 = (SemanticPredicate(qa.embed, SimulatedOracle(qa.truth), name="a")
             & ~SemanticPredicate(qb.embed, SimulatedOracle(qb.truth),
                                  name="b"))
    opt = QueryOptimizer()
    res = _engine(corpus).session_view(optimizer=opt).filter(
        SemanticTopK(pred2, k=8), seed=0)
    accepted = np.flatnonzero(res.mask)
    assert 0 < len(accepted) <= 8
    assert full.mask[accepted].all()
    assert opt.snapshot()["topk_queries"] == 1


# -- parity with the JAX package -------------------------------------------

PROXY = dict(embed_dim=32, hidden_dim=64, latent_dim=32, proj_dim=16,
             phase1_steps=20, phase2_steps=20, batch_size=64)
SELS = (0.3, 0.4)


@pytest.fixture(scope="module")
def pcorpus():
    return make_corpus(0, n_docs=1500, dim=32)


@pytest.fixture(scope="module")
def queries(pcorpus):
    return [make_query(pcorpus, 40 + j, selectivity=s)
            for j, s in enumerate(SELS)]


@pytest.fixture(scope="module")
def jax_params(pcorpus, queries):
    """Each leaf trained once, in one run of the JAX engine."""
    je = JEngine(JStore(pcorpus.embeds), JProxyCfg(**PROXY),
                 JCascadeCfg(accuracy_target=TARGET))
    preds = [JPred(q.embed, JOracle(q.truth)) for q in queries]
    je.filter(preds[0] & preds[1], seed=0)
    return [je._proxies[p.key] for p in preds]


class Accepted:
    """Observer: the accepted documents in the order they were accepted."""

    def __init__(self):
        self.order = []

    def on_partial(self, accepted, rejected):
        self.order.extend(int(d) for d in accepted)


FORMS = {"leaf": lambda p: p[0], "and_not": lambda p: p[0] & ~p[1]}
CASES = {"leaf_k10": ("leaf", 10), "leaf_k150": ("leaf", 150),
         "and_not_k25": ("and_not", 25)}


def _topk_pair(embeds, queries, params, form, k):
    """Both engines (params injected when given) and their results."""
    out = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            eng = JEngine(JStore(embeds), JProxyCfg(**PROXY),
                          JCascadeCfg(accuracy_target=TARGET))
            leaves = [JPred(q.embed, JOracle(q.truth), name=f"p{j + 1}")
                      for j, q in enumerate(queries)]
            topk = JTopK(FORMS[form](leaves), k=k)
        else:
            eng = ScaleDocEngine(InMemoryStore(embeds), ProxyConfig(**PROXY),
                                 CascadeConfig(accuracy_target=TARGET),
                                 device="cpu")
            leaves = [SemanticPredicate(q.embed, SimulatedOracle(q.truth),
                                        name=f"p{j + 1}")
                      for j, q in enumerate(queries)]
            topk = SemanticTopK(FORMS[form](leaves), k=k)
        for leaf, p in zip(leaves, params or ()):
            eng._proxies[leaf.key] = (p if pkg == "jax"
                                      else params_from_jax(p))
        obs = Accepted()
        eng._observer = obs
        res = eng.filter(topk, seed=0)
        out.append((eng, topk, res, obs.order))
    return out


def _assert_same(jax_run, port_run):
    (_, _, rj, acc_j), (_, _, rt, acc_t) = jax_run, port_run
    assert rt.plan == rj.plan
    assert acc_t == acc_j
    np.testing.assert_array_equal(rt.mask, rj.mask)
    assert len(rt.leaf_reports) == len(rj.leaf_reports)
    for a, b in zip(rj.leaf_reports, rt.leaf_reports):
        assert b.name == a.name and b.n_pending == a.n_pending
        np.testing.assert_array_equal(b.pending, a.pending)
        np.testing.assert_array_equal(b.labels, a.labels)
        if a.scores is not None:
            assert np.abs(b.scores - a.scores).max() <= SCORE_TOL
        assert (b.oracle_calls_train, b.oracle_calls_calib,
                b.oracle_calls_online, b.oracle_docs_charged) == \
            (a.oracle_calls_train, a.oracle_calls_calib,
             a.oracle_calls_online, a.oracle_docs_charged)
    assert (rt.oracle_calls_total, rt.oracle_calls_train) == \
        (rj.oracle_calls_total, rj.oracle_calls_train)
    np.testing.assert_array_equal(rt.provenance.class_of,
                                  rj.provenance.class_of)
    np.testing.assert_array_equal(rt.provenance.leaf_of,
                                  rj.provenance.leaf_of)
    assert rt.provenance.leaf_names == rj.provenance.leaf_names
    assert rt.provenance.complete()
    assert len(rt.provenance.docs_in("topk_skip")) > 0
    assert not rt.degraded


@pytest.mark.parametrize("case", sorted(CASES))
def test_injected_params_give_the_reference_topk(pcorpus, queries,
                                                 jax_params, case):
    form, k = CASES[case]
    jax_run, port_run = _topk_pair(pcorpus.embeds, queries, jax_params,
                                   form, k)
    je, jtopk, rj, _ = jax_run
    edges = np.linspace(0.0, 1.0, JCascadeCfg().num_bins + 1)
    arts = {a.key: a for a in je._decisions.values()}
    for art in arts.values():
        gap = np.abs(art.scores[:, None] - edges[None, :]).min()
        assert gap > SCORE_TOL, f"precondition: a score lies {gap:g} " \
            "from a calibration bin edge"
    rank = je._fuzzy_rank(jtopk.child,
                          {key: a.scores for key, a in arts.items()})
    assert rank.dtype == np.float32
    walked = rj.leaf_reports[0].n_pending      # the first leaf sees all
    prefix = rank[np.argsort(-rank, kind="stable")[:walked + 1]]
    gap = np.abs(np.diff(prefix)).min()
    assert gap > SCORE_TOL, f"precondition: two walked ranks {gap:g} apart"
    # the walk stopped early: documents were left unwalked
    assert walked < len(pcorpus.embeds)
    _assert_same(jax_run, port_run)
    assert len(port_run[3]) == int(rj.mask.sum()) == k


@pytest.mark.parametrize("form", sorted(FORMS))
def test_direct_label_route_is_the_reference(form):
    """A collection of at most DIRECT_LABEL_CUTOFF documents labels every
    document and keeps the k lowest doc ids among the members (the
    route streams no partial results, so the accepted list is the
    mask's)."""
    corpus = make_corpus(3, n_docs=DIRECT_LABEL_CUTOFF, dim=32)
    qs = [make_query(corpus, 80 + j, selectivity=s)
          for j, s in enumerate(SELS)]
    jax_run, port_run = _topk_pair(corpus.embeds, qs, None, form, 5)
    _assert_same(jax_run, port_run)
    _, ttopk, rt, _ = port_run
    assert rt.leaf_reports[0].n_pending == DIRECT_LABEL_CUTOFF
    truth = ttopk.child.evaluate({
        lf.key: lf.oracle._labels.astype(np.int8)
        for lf in ttopk.child.leaves()}) == 1
    np.testing.assert_array_equal(np.flatnonzero(rt.mask),
                                  np.flatnonzero(truth)[:5])
    assert (rt.provenance.class_of != trace_mod.PROXY_ACCEPT).all()
