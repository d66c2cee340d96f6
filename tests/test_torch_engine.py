"""Port parity of the engine's online phase (``filter``/``query`` of one
SemanticPredicate) against the JAX package's ScaleDocEngine.

(a) Reference-trained params injected into both engines: the scores
    agree to SCORE_TOL, and then the decisions, thresholds and oracle
    calls must be equal. A score within SCORE_TOL of a calibration bin
    edge could fall into the neighbouring bin and change the stratified
    calibration sample (calibration.py's searchsorted), and the
    thresholds l, r are bin edges too; so the test asserts, as a stated
    precondition, that no score lies within SCORE_TOL of an edge.
(b) Each engine trains its own proxy (the draws differ: threefry vs
    torch generators), over 3 seeds: the port's F1 >= target - 0.03,
    and its oracle calls over the 3 queries are within 15% of the
    reference's (per query they vary by ~30% between two proxies).
"""
import numpy as np
import pytest

from repro.config.base import CascadeConfig as JCascadeCfg
from repro.config.base import ProxyConfig as JProxyCfg
from repro.core.oracle import SimulatedOracle as JOracle
from repro.engine import InMemoryStore as JStore
from repro.engine import ScaleDocEngine as JEngine
from repro.engine import SemanticPredicate as JPred
from repro_torch.config import CascadeConfig, ProxyConfig
from repro_torch.core.encoder import params_from_jax
from repro_torch.data import make_corpus, make_query
from repro_torch.engine import (InMemoryStore, ScaleDocEngine,
                                SemanticPredicate, SemanticTopK,
                                SimulatedOracle)
from torch_threads import one_torch_thread  # noqa: F401

TARGET = 0.9
SCORE_TOL = 1e-6
PROXY = dict(embed_dim=32, hidden_dim=64, latent_dim=32, proj_dim=16,
             phase1_steps=20, phase2_steps=20, batch_size=64)


def _engines(embeds, proxy, strategy="scaledoc"):
    je = JEngine(JStore(embeds), JProxyCfg(**proxy),
                 JCascadeCfg(accuracy_target=TARGET), strategy=strategy)
    te = ScaleDocEngine(InMemoryStore(embeds), ProxyConfig(**proxy),
                        CascadeConfig(accuracy_target=TARGET),
                        strategy=strategy, device="cpu")
    return je, te


# "probe" has no threshold split: the engine runs it whole
@pytest.mark.parametrize("strategy", ["scaledoc", "naive", "probe"])
def test_injected_params_give_the_reference_decisions(strategy):
    corpus = make_corpus(0, n_docs=1500, dim=32)
    q = make_query(corpus, 7, selectivity=0.3)
    trainer, _ = _engines(corpus.embeds, PROXY)
    trainer.filter(JPred(q.embed, JOracle(q.truth)), seed=0)
    params = next(iter(trainer._proxies.values()))

    je, te = _engines(corpus.embeds, PROXY, strategy)
    jpred = JPred(q.embed, JOracle(q.truth))
    tpred = SemanticPredicate(q.embed, SimulatedOracle(q.truth))
    assert jpred.key.split(":")[0] == tpred.key.split(":")[0]
    je._proxies[jpred.key] = params
    te._proxies[tpred.key] = params_from_jax(params)
    rj = je.filter(jpred, ground_truth=q.truth, seed=0)
    rt = te.filter(tpred, ground_truth=q.truth, seed=0)

    s_j, s_t = rj.leaf_reports[0].scores, rt.leaf_reports[0].scores
    assert np.abs(s_t - s_j).max() <= SCORE_TOL
    # the bin edges, and probe's 0.5 cut (an edge too)
    edges = np.linspace(0.0, 1.0, JCascadeCfg().num_bins + 1)
    gap = np.abs(s_j[:, None] - edges[None, :]).min()
    assert gap > SCORE_TOL, f"precondition: a score lies {gap:g} from a " \
        "calibration bin edge"

    np.testing.assert_array_equal(rt.mask, rj.mask)
    cj, ct = rj.leaf_reports[0].cascade, rt.leaf_reports[0].cascade
    assert (ct.l, ct.r, ct.est_accuracy, ct.certified) == \
        (cj.l, cj.r, cj.est_accuracy, cj.certified)
    assert rt.oracle_calls_total == rj.oracle_calls_total
    assert (ct.oracle_calls_calib, ct.oracle_calls_online) == \
        (cj.oracle_calls_calib, cj.oracle_calls_online)
    assert rt.oracle_calls_train == rj.oracle_calls_train == 0
    assert rt.achieved_f1 == rj.achieved_f1
    assert rt.scoring_stats.paths == ("fused",)

    # query(): same predicate, cached proxy and decisions -> free
    st = te.query(q.embed, tpred.oracle, ground_truth=q.truth, seed=0)
    assert st.oracle_calls_total == 0
    np.testing.assert_array_equal(st.cascade.labels, rt.mask)


def test_port_trained_engine_tracks_the_reference():
    proxy = dict(PROXY, embed_dim=64, latent_dim=64, phase1_steps=30,
                 phase2_steps=30)
    corpus = make_corpus(0, n_docs=3000, dim=64)
    calls_j = calls_t = 0
    for seed, sel in enumerate((0.15, 0.3, 0.45)):
        q = make_query(corpus, 100 + seed, selectivity=sel)
        je, te = _engines(corpus.embeds, proxy)
        rj = je.filter(JPred(q.embed, JOracle(q.truth)), ground_truth=q.truth,
                       seed=seed)
        rt = te.filter(SemanticPredicate(q.embed, SimulatedOracle(q.truth)),
                       ground_truth=q.truth, seed=seed)
        assert rt.achieved_f1 >= TARGET - 0.03, (seed, rt.achieved_f1)
        assert rt.oracle_calls_train == rj.oracle_calls_train
        assert rt.oracle_calls_total < len(corpus.embeds)
        calls_j += rj.oracle_calls_total
        calls_t += rt.oracle_calls_total
    assert abs(calls_t - calls_j) <= 0.15 * calls_j, (calls_t, calls_j)


def test_unported_paths_raise():
    """What the port refuses: an unknown degrade policy and a raw
    (e_q, oracle) pair. A tracer on a session view, once refused here,
    is taken by the view alone (test_torch_trace.py); top-k and the
    degrade policies run (test_torch_topk.py, test_torch_degrade.py)."""
    from repro_torch.runtime import trace as trace_mod
    corpus = make_corpus(0, n_docs=200, dim=16)
    q = make_query(corpus, 1)
    te = ScaleDocEngine(corpus.embeds, device="cpu")
    tracer = trace_mod.Tracer()
    assert te.session_view(tracer=tracer)._tracer is tracer
    assert te._tracer is trace_mod.NULL_TRACER
    with pytest.raises(ValueError, match="degrade"):
        ScaleDocEngine(corpus.embeds, degrade="retry", device="cpu")
    pred = SemanticPredicate(q.embed, SimulatedOracle(q.truth))
    with pytest.raises(ValueError, match="degrade"):
        te.filter(pred, degrade="ignore")
    with pytest.raises(TypeError):
        te.filter((q.embed, SimulatedOracle(q.truth)))
    assert ScaleDocEngine(corpus.embeds, degrade="defer",
                          device="cpu").degrade == "defer"
    assert isinstance(SemanticTopK(pred, k=5).child, SemanticPredicate)


def test_tiny_collection_labels_directly():
    corpus = make_corpus(0, n_docs=40, dim=16)
    q = make_query(corpus, 1)
    te = ScaleDocEngine(corpus.embeds, device="cpu")
    st = te.query(q.embed, SimulatedOracle(q.truth), ground_truth=q.truth)
    assert st.oracle_calls_total == 40 and st.cascade.achieved_f1 == 1.0
