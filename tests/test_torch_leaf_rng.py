"""A leaf's cost differs between the packages only through the proxy's
random draws.

The port trains its proxy from a torch seed where the JAX engine folds
the same (seed, leaf) pair into a threefry key, so the two packages'
proxies, and with them a leaf's thresholds and oracle calls, differ by
design (at N = 16,384 the selectivity-0.3 leaf of
tests/torch_compound_calls.py costs 12,760 calls in the JAX package and
15,674 in the port; tests/torch_leaf_rng.py). Given the JAX engine's own
draws as a ``DrawPlan`` (tests/torch_jax_draws.py), on the JAX engine's
own training sample, the port trains the same proxy and makes the same
decisions: here, that very leaf at N = 16,384 under ``ProxyConfig()``.

Tolerances: the params agree to 1e-5 (absolute and relative, as
tests/test_torch_trainer.py: float32 rounding of matmuls summed in
another order, which Adam amplifies over the 120 steps; measured on the
CPU, at most 7.2e-6) and the scores to SCORE_TOL = 1e-5 (measured 2.6e-6).
The decisions are then held bitwise: the calibration sample, l, r, the
calls and the mask must be equal. (No bin-edge precondition is stated:
a score crossing an edge would change the calibration sample, which the
test checks directly.)
"""
import numpy as np

from repro.config.base import CascadeConfig as JCascadeCfg
from repro.config.base import ProxyConfig as JProxyCfg
from repro.core.oracle import SimulatedOracle as JOracle
from repro.engine import InMemoryStore as JStore
from repro.engine import ScaleDocEngine as JEngine
from repro.engine import SemanticPredicate as JPred
from repro_torch.config import CascadeConfig, ProxyConfig
from repro_torch.core.encoder import params_from_jax, tree_leaves
from repro_torch.data import make_corpus, make_query
from repro_torch.engine import (InMemoryStore, ScaleDocEngine,
                                SemanticPredicate, SimulatedOracle)
from torch_jax_draws import port_params
from torch_threads import one_torch_thread  # noqa: F401

DIM = 4096
NOISE = 0.03 * (256 / DIM) ** 0.5
N_DOCS = 16_384
SCORE_TOL = 1e-5
DRIFT = dict(rtol=1e-5, atol=1e-5)


def test_jax_draws_give_the_reference_leaf():
    corpus = make_corpus(0, n_docs=N_DOCS, dim=DIM, noise=NOISE)
    q = make_query(corpus, 102, selectivity=0.3)
    je = JEngine(JStore(corpus.embeds), JProxyCfg(),
                 JCascadeCfg(accuracy_target=0.9))
    jleaf = JPred(q.embed, JOracle(q.truth))
    rj = je.filter(jleaf, ground_truth=q.truth, seed=0)

    te = ScaleDocEngine(InMemoryStore(corpus.embeds), ProxyConfig(),
                        CascadeConfig(accuracy_target=0.9), device="cpu")
    tleaf = SemanticPredicate(q.embed, SimulatedOracle(q.truth))
    assert tleaf.key.split(":")[0] == jleaf.key.split(":")[0]
    # the training sample is labelled through the engine's label cache,
    # as its own training would be
    params = port_params(je, jleaf, 0, te._cached_oracle(tleaf.oracle).label,
                         ProxyConfig())
    train_calls = tleaf.oracle.calls
    te._proxies[tleaf.key] = params
    rt = te.filter(tleaf, ground_truth=q.truth, seed=0)

    for a, b in zip(tree_leaves(params_from_jax(je._proxies[jleaf.key])),
                    tree_leaves(params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **DRIFT)
    s_j, s_t = rj.leaf_reports[0].scores, rt.leaf_reports[0].scores
    assert np.abs(s_t - s_j).max() <= SCORE_TOL
    (aj,), (at,) = je._decisions.values(), te._decisions.values()
    np.testing.assert_array_equal(at.sample_idx, aj.sample_idx)
    np.testing.assert_array_equal(at.sample_labels, aj.sample_labels)

    cj, ct = rj.leaf_reports[0].cascade, rt.leaf_reports[0].cascade
    assert (ct.l, ct.r, ct.est_accuracy) == (cj.l, cj.r, cj.est_accuracy)
    assert train_calls == rj.oracle_calls_train
    assert train_calls + rt.oracle_calls_total == rj.oracle_calls_total
    assert (ct.oracle_calls_calib, ct.oracle_calls_online) == \
        (cj.oracle_calls_calib, cj.oracle_calls_online)
    np.testing.assert_array_equal(rt.mask, rj.mask)
