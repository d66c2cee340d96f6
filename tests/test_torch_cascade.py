"""The port's numpy copies are bitwise equal to the JAX package's:
synthetic data, calibration and threshold selection, the cascade,
oracle accounting and the predicate key."""
import numpy as np
import pytest

from repro.config.base import CascadeConfig as JCascadeCfg
from repro.core import cascade as j_cascade
from repro.core.oracle import CachedOracle as JCached
from repro.core.oracle import SimulatedOracle as JSim
from repro.data.synthetic import make_corpus as j_corpus
from repro.data.synthetic import make_query as j_query
from repro.engine.predicate import SemanticPredicate as JPred
from repro_torch.config import CascadeConfig
from repro_torch.core import cascade as t_cascade
from repro_torch.core.oracle import CachedOracle, SimulatedOracle
from repro_torch.data import make_corpus, make_query
from repro_torch.engine.predicate import SemanticPredicate
from repro_torch.engine.registry import available_strategies, get_strategy


def test_synthetic_data_is_bitwise_equal():
    a, b = make_corpus(3, n_docs=500, dim=24), j_corpus(3, n_docs=500,
                                                         dim=24)
    for f in ("embeds", "topic_weights", "topics"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    qa, qb = make_query(a, 9, selectivity=0.2), j_query(b, 9,
                                                       selectivity=0.2)
    np.testing.assert_array_equal(qa.embed, qb.embed)
    np.testing.assert_array_equal(qa.truth, qb.truth)
    assert (qa.selectivity, qa.topic_a, qa.topic_b) == \
        (qb.selectivity, qb.topic_a, qb.topic_b)


def _scores_truth(seed=0, n=4000):
    rng = np.random.default_rng(seed)
    truth = rng.random(n) < 0.3
    scores = np.clip(np.where(truth, 0.65, 0.4)
                     + 0.12 * rng.normal(size=n), 0, 1).astype(np.float32)
    return scores, truth


@pytest.mark.parametrize("margin_mode", ["bootstrap", "bernstein", "none"])
@pytest.mark.parametrize("metric", ["f1", "exact"])
def test_calibrate_thresholds_and_cascade_bitwise(margin_mode, metric):
    scores, truth = _scores_truth()
    kw = dict(accuracy_target=0.9, margin_mode=margin_mode, metric=metric)
    t_or, j_or = SimulatedOracle(truth), JSim(truth)
    t_spec = t_cascade.calibrate_thresholds(
        scores, t_or, CascadeConfig(**kw), np.random.default_rng(5))
    j_spec = j_cascade.calibrate_thresholds(
        scores, j_or, JCascadeCfg(**kw), np.random.default_rng(5))
    assert (t_spec.l, t_spec.r, t_spec.est_accuracy, t_spec.certified,
            t_spec.oracle_calls_calib) == \
        (j_spec.l, j_spec.r, j_spec.est_accuracy, j_spec.certified,
         j_spec.oracle_calls_calib)
    np.testing.assert_array_equal(t_spec.sample_idx, j_spec.sample_idx)
    t_res = t_cascade.run_cascade(scores, SimulatedOracle(truth),
                                  CascadeConfig(**kw), truth,
                                  np.random.default_rng(6))
    j_res = j_cascade.run_cascade(scores, JSim(truth), JCascadeCfg(**kw),
                                  truth, np.random.default_rng(6))
    np.testing.assert_array_equal(t_res.labels, j_res.labels)
    for f in ("l", "r", "unfiltered_rate", "oracle_calls_online",
              "oracle_calls_calib", "est_accuracy", "achieved_f1",
              "data_reduction", "certified"):
        assert getattr(t_res, f) == getattr(j_res, f), f


@pytest.mark.parametrize("strategy", ["naive", "probe", "supg"])
def test_baseline_strategies_bitwise(strategy):
    from repro.engine.registry import get_strategy as j_get
    scores, truth = _scores_truth(1)
    t_or, j_or = SimulatedOracle(truth), JSim(truth)
    t_res = get_strategy(strategy)(scores, t_or, CascadeConfig(),
                                   ground_truth=truth)
    j_res = j_get(strategy)(scores, j_or, JCascadeCfg(), ground_truth=truth)
    np.testing.assert_array_equal(t_res.labels, j_res.labels)
    assert t_or.calls == j_or.calls
    assert available_strategies() == ["naive", "probe", "scaledoc", "supg"]


def test_oracle_accounting_matches():
    truth = np.arange(50) % 3 == 0
    t_c, j_c = CachedOracle(SimulatedOracle(truth)), JCached(JSim(truth))
    for ask in ([1, 2, 3], [2, 3, 4, 4], [10, 1], [], [7] * 5):
        np.testing.assert_array_equal(t_c.label(ask), j_c.label(ask))
        assert t_c.calls == j_c.calls
        assert t_c.stats() == j_c.stats()
    noisy_t = SimulatedOracle(truth, flip_noise=0.2, seed=4)
    noisy_j = JSim(truth, flip_noise=0.2, seed=4)
    np.testing.assert_array_equal(noisy_t.label(np.arange(50)),
                                  noisy_j.label(np.arange(50)))


def test_predicate_key_matches():
    e = np.random.default_rng(0).normal(size=16).astype(np.float32)
    oracle = object()
    t, j = SemanticPredicate(e, oracle), JPred(e, oracle)
    assert t.key == j.key and t.name == j.name
    # composition builds the reference's tree over the same keys
    expr, jexpr = t & ~SemanticPredicate(-e, oracle), j & ~JPred(-e, oracle)
    assert [lf.key for lf in expr.leaves()] == \
        [lf.key for lf in jexpr.leaves()]
    assert repr(expr) == repr(jexpr) and repr(~t) == repr(~j)
