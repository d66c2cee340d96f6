"""The port's ablation surface (the paper's Table 4 and Fig. 9 helpers)
against the JAX package.

(a) The JAX package's own tests of these functions, run on the port:
    the trainer variants (tests/test_trainer.py, the variant and MLP
    tests), the frontier against the O(B^2) brute force, its hypothesis
    property, and the interpolated density beating the Beta fit
    (tests/test_calibration_thresholds.py).
(b) Bitwise parity of the numpy copies: ``beta_fit_density``,
    ``brute_force_thresholds``, ``oracle_optimal_thresholds`` and
    ``make_workload``.
(c) Each ``train_proxy_variant`` on a ``DrawPlan`` built from the JAX
    key the reference variant trains with: params agree within the
    trainer tests' drift tolerance (1e-5 absolute and relative after 16
    steps; tests/test_torch_trainer.py says where the drift comes from),
    and ``mlp_classifier_scores`` on equal params within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.config.base import CascadeConfig as JCascadeCfg
from repro.config.base import ProxyConfig as JProxyCfg
from repro.core import calibration as JC
from repro.core import thresholds as JT
from repro.core import trainer as jtr
from repro.core.encoder import encoder_init
from repro.data import make_workload as j_workload
from repro.models.common import dense_init
from repro_torch.config import CascadeConfig, ProxyConfig
from repro_torch.core import calibration as C
from repro_torch.core import thresholds as T
from repro_torch.core import trainer as ttr
from repro_torch.core.encoder import tree_leaves
from repro_torch.data import make_workload
from torch_jax_draws import lane_draws
from torch_threads import one_torch_thread  # noqa: F401

DIM = 32
CFG = dict(embed_dim=DIM, hidden_dim=32, latent_dim=16, proj_dim=8,
           phase1_steps=8, phase2_steps=8, batch_size=32)
DRIFT = dict(rtol=1e-5, atol=1e-5)
SCORE_TOL = 1e-6
VARIANTS = ("qsim", "qsim+supcon", "qsim+polar", "full", "mlp")


@pytest.fixture(scope="module")
def sample():
    rng = np.random.default_rng(0)
    n = 150
    embeds = rng.normal(size=(n, DIM)).astype(np.float32)
    labels = (rng.random(n) < 0.3).astype(np.float32)
    e_q = rng.normal(size=DIM).astype(np.float32)
    return e_q, embeds, labels


# -- (a) the JAX package's tests, on the port ------------------------------

def test_variants_are_config_rewrites_of_one_trainer(sample):
    e_q, embeds, labels = sample
    cfg = ProxyConfig(**CFG)
    for variant in ("qsim", "qsim+supcon", "qsim+polar", "full"):
        params = ttr.train_proxy_variant(3, e_q, embeds, labels, cfg,
                                         variant, device="cpu")
        assert set(params) == {"layers", "proj"}
        again = ttr.train_proxy_variant(3, e_q, embeds, labels, cfg,
                                        variant, device="cpu")
        for a, b in zip(tree_leaves(params), tree_leaves(again)):
            assert torch.equal(a, b)
    # 'qsim' == a two-phase run with every step on the phase-1 objective
    qsim = ttr.train_proxy_variant(3, e_q, embeds, labels, cfg, "qsim",
                                   device="cpu")
    cfg_q = dataclasses.replace(cfg, rebalance=False,
                                phase1_steps=cfg.phase1_steps
                                + cfg.phase2_steps, phase2_steps=0)
    ref = ttr.train_proxy(3, e_q, embeds, labels, cfg_q, device="cpu")
    for a, b in zip(tree_leaves(qsim), tree_leaves(ref.params)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="variant"):
        ttr.train_proxy_variant(3, e_q, embeds, labels, cfg, "supcon",
                                device="cpu")


def test_mlp_variant_trains_classifier(sample):
    e_q, embeds, labels = sample
    cfg = ProxyConfig(**CFG)
    params = ttr.train_proxy_variant(5, e_q, embeds, labels, cfg, "mlp",
                                     device="cpu")
    assert set(params) == {"w1", "b1", "w2", "b2", "w3", "b3"}
    scores = ttr.mlp_classifier_scores(params, embeds).numpy()
    assert scores.shape == (len(embeds),)
    assert (scores >= 0).all() and (scores <= 1).all()
    # training moved the classifier toward the labels
    pos = labels.astype(bool)
    assert scores[pos].mean() > scores[~pos].mean()


def _make_scores(seed=0, n=4000, sep=2.0, pos_frac=0.3):
    rng = np.random.default_rng(seed)
    npos = int(n * pos_frac)
    pos = 1 / (1 + np.exp(-(rng.normal(sep / 2, 1.0, npos))))
    neg = 1 / (1 + np.exp(-(rng.normal(-sep / 2, 1.0, n - npos))))
    scores = np.concatenate([pos, neg])
    labels = np.concatenate([np.ones(npos, bool), np.zeros(n - npos, bool)])
    perm = rng.permutation(n)
    return scores[perm], labels[perm]


def _calibrate(mod, cfg, scores, labels):
    return mod.calibrate(scores, lambda idx: labels[idx], cfg,
                         np.random.default_rng(0))


def test_frontier_matches_brute_force():
    """Algorithm 2's staircase equals the O(B^2) optimum."""
    for seed in range(5):
        scores, labels = _make_scores(seed=seed, sep=2.5)
        calib = _calibrate(C, CascadeConfig(), scores, labels)
        for alpha in (0.85, 0.9, 0.95):
            fast = T.select_thresholds(calib, alpha)
            brute = T.brute_force_thresholds(calib, alpha)
            assert fast.feasible == brute.feasible
            if fast.feasible:
                assert fast.unfiltered <= brute.unfiltered + 1e-9, (
                    seed, alpha, fast, brute)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 1000), sep=st.floats(0.5, 5.0),
       alpha=st.floats(0.8, 0.97), pos_frac=st.floats(0.1, 0.6))
def test_frontier_optimality_property(seed, sep, alpha, pos_frac):
    scores, labels = _make_scores(seed=seed, n=1500, sep=sep,
                                  pos_frac=pos_frac)
    calib = _calibrate(C, CascadeConfig(num_bins=32), scores, labels)
    fast = T.select_thresholds(calib, alpha)
    brute = T.brute_force_thresholds(calib, alpha)
    assert fast.feasible == brute.feasible
    if fast.feasible:
        assert fast.unfiltered <= brute.unfiltered + 1e-9


def _bimodal_positives():
    rng0 = np.random.default_rng(0)
    n = 4000
    main = np.clip(rng0.normal(0.88, 0.05, int(n * 0.8)), 0, 1)
    tail = np.clip(rng0.normal(0.35, 0.08, n - len(main)), 0, 1)
    scores = np.concatenate([main, tail])
    edges = C.discretize(64)
    idx = C.stratified_sample(scores, 0.05, edges,
                              np.random.default_rng(1))
    return scores, edges, scores[idx]


def test_de_jsd_better_than_beta():
    """Linear-interp DE beats a Beta fit on the bimodal score
    distributions bipolar proxies actually produce (paper Table 4)."""
    scores, edges, s_pos = _bimodal_positives()
    truth = C.naive_density(scores, edges)

    def jsd(d1, d2):
        p = d1.pdf / max(d1.pdf.sum(), 1e-12)
        q = d2.pdf / max(d2.pdf.sum(), 1e-12)
        m = 0.5 * (p + q)

        def kl(a, b):
            mask = a > 0
            return float(np.sum(a[mask] * np.log(a[mask] / np.maximum(
                b[mask], 1e-12))))
        return 0.5 * kl(p, m) + 0.5 * kl(q, m)

    ours = C.reconstruct_density(s_pos, edges, CascadeConfig(),
                                 np.random.default_rng(2))
    beta = C.beta_fit_density(s_pos, edges)
    assert jsd(ours, truth) < jsd(beta, truth)


# -- (b) the numpy copies, bitwise -----------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 200])
def test_beta_fit_density_bitwise(n):
    _, edges, s_pos = _bimodal_positives()
    s = s_pos[:n]
    a, b = C.beta_fit_density(s, edges), JC.beta_fit_density(s, edges)
    for f in ("pdf", "cdf_edges", "edges"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("metric", ["f1", "exact"])
@pytest.mark.parametrize("margin", [0.0, 0.02])
def test_brute_force_thresholds_bitwise(metric, margin):
    scores, labels = _make_scores(seed=3, n=1500, sep=2.5)
    tc = _calibrate(C, CascadeConfig(num_bins=32), scores, labels)
    jc = _calibrate(JC, JCascadeCfg(num_bins=32), scores, labels)
    for alpha in (0.85, 0.95, 0.999):
        a = T.brute_force_thresholds(tc, alpha, metric, margin)
        b = JT.brute_force_thresholds(jc, alpha, metric, margin)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)


@pytest.mark.parametrize("metric", ["f1", "exact"])
def test_oracle_optimal_thresholds_bitwise(metric):
    scores, labels = _make_scores(seed=4, n=2000, sep=2.0)
    edges = C.discretize(64)
    for alpha in (0.8, 0.9, 0.99, 1.01):
        a = T.oracle_optimal_thresholds(scores, labels, edges, alpha,
                                        metric)
        b = JT.oracle_optimal_thresholds(scores, labels, edges, alpha,
                                         metric)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert not T.oracle_optimal_thresholds(scores, labels, edges,
                                           1.01).feasible


@pytest.mark.parametrize("selectivities", [None, (0.1, 0.45)])
def test_make_workload_bitwise(selectivities):
    a_c, a_q = make_workload(7, n_docs=600, dim=24, n_queries=3,
                             selectivities=selectivities)
    b_c, b_q = j_workload(7, n_docs=600, dim=24, n_queries=3,
                          selectivities=selectivities)
    np.testing.assert_array_equal(a_c.embeds, b_c.embeds)
    assert len(a_q) == len(b_q)
    for qa, qb in zip(a_q, b_q):
        np.testing.assert_array_equal(qa.embed, qb.embed)
        np.testing.assert_array_equal(qa.truth, qb.truth)
        assert qa.selectivity == qb.selectivity


# -- (c) the variants on the JAX package's draws ----------------------------

def _variant_cfg(jcfg, variant):
    """The config the JAX variant trains under (trainer.py:386-397)."""
    rewrites = {
        "qsim": dict(phase1_steps=jcfg.phase1_steps + jcfg.phase2_steps,
                     phase2_steps=0),
        "qsim+supcon": dict(lambda_supcon=1.0),
        "qsim+polar": dict(lambda_supcon=0.0),
    }
    if variant in rewrites:
        return dataclasses.replace(jcfg, rebalance=False,
                                   **rewrites[variant])
    return jcfg


def _variant_plan(key, embeds, labels, jcfg, variant):
    """The draws JAX's ``train_proxy_variant(key, ...)`` makes, as a
    one-lane DrawPlan."""
    if variant == "mlp":
        k1, k2, k3, ktrain = jax.random.split(key, 4)
        h = jcfg.hidden_dim
        params = {"w1": dense_init(k1, jcfg.embed_dim, (h,), jnp.float32),
                  "b1": jnp.zeros((h,)),
                  "w2": dense_init(k2, h, (h,), jnp.float32),
                  "b2": jnp.zeros((h,)),
                  "w3": dense_init(k3, h, (1,), jnp.float32),
                  "b3": jnp.zeros((1,))}
        n_valid, kbal_seed = len(embeds), 0
    else:
        vcfg = _variant_cfg(jcfg, variant)
        kinit, kbal, ktrain = jax.random.split(key, 3)
        params = encoder_init(kinit, vcfg)
        e_bal = (jtr.rebalance(kbal, embeds, labels, vcfg)[0]
                 if vcfg.rebalance else embeds)
        n_valid, kbal_seed = len(e_bal), jtr._key_seed(kbal)
    idx, noise = lane_draws(ktrain, n_valid, jcfg)
    return ttr.DrawPlan(
        params=jax.tree.map(lambda a: np.asarray(a)[None], params),
        rebalance_seeds=[kbal_seed], idx=idx[None], noise=noise[None])


@pytest.mark.parametrize("pos_frac", [0.3, 0.08])   # 0.08: full rebalances
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_on_jax_draws_matches_jax(variant, pos_frac):
    jcfg, cfg = JProxyCfg(**CFG), ProxyConfig(**CFG)
    rng = np.random.default_rng(11)
    embeds = rng.normal(size=(150, DIM)).astype(np.float32)
    labels = (rng.random(150) < pos_frac).astype(np.float32)
    e_q = rng.normal(size=DIM).astype(np.float32)
    key = jax.random.PRNGKey(21)
    ref = jtr.train_proxy_variant(key, e_q, embeds, labels, jcfg, variant,
                                  method="steps")
    got = ttr.train_proxy_variant(
        0, e_q, embeds, labels, cfg, variant, device="cpu",
        plan=_variant_plan(key, embeds, labels, jcfg, variant))
    for a, b in zip(jax.tree.leaves(ref), tree_leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **DRIFT)
    if variant == "mlp":
        jparams = jax.tree.map(np.asarray, ref)
        tparams = {k: torch.tensor(v) for k, v in jparams.items()}
        np.testing.assert_allclose(
            ttr.mlp_classifier_scores(tparams, embeds).numpy(),
            np.asarray(jtr.mlp_classifier_scores(jparams, embeds)),
            rtol=0, atol=SCORE_TOL)
