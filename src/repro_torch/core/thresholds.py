"""Threshold selection (paper §4.3, Algorithm 2).

Given calibrated class-conditional CDFs, select (l, r) minimizing the
unfiltered rate u(l, r) subject to Acc(l, r) >= alpha.

Accuracy model (F1, matching §4.4): with F+ = positive prior,
  FN(l) = F+ * CDF_P(l)              (positives auto-labeled negative)
  FP(r) = F- * (1 - CDF_N(r))        (negatives auto-labeled positive)
  TP    = F+ - FN(l)                 (oracle region is perfect)
  F1(l, r) = 2 TP / (2 TP + FP + FN)
Exact-match variant: Acc = 1 - FP - FN (for the BARGAIN comparison).

The frontier traversal is the linear-time staircase walk: starting from
(l0, r_s) — the tightest feasible lower bound at the most conservative
upper bound — repeatedly try to tighten r by one bin; when that violates
the constraint, loosen l by one bin (regaining slack). Every Pareto point
at bin granularity is visited once, so the argmin of u over the path is
the constrained optimum (the JAX package's tests validate it against
an O(B^2) brute force). This is our reading of Algorithm 2's pseudocode, whose published
`l + bins.size` steps have an (apparent) sign typo.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.calibration import Calibration


@dataclasses.dataclass
class ThresholdResult:
    l: float
    r: float
    unfiltered: float
    est_accuracy: float
    feasible: bool
    path_len: int = 0


def accuracy_est(calib: Calibration, l: float, r: float,
                 metric: str = "f1") -> float:
    fp_prior = calib.prior_pos
    fn_mass = fp_prior * calib.pdf_pos.cdf(l)
    fp_mass = (1 - fp_prior) * (1.0 - calib.pdf_neg.cdf(r))
    tp = fp_prior - fn_mass
    if metric == "exact":
        return float(1.0 - fp_mass - fn_mass)
    denom = 2 * tp + fp_mass + fn_mass
    return float(2 * tp / denom) if denom > 0 else 0.0


def unfiltered_est(calib: Calibration, l: float, r: float) -> float:
    p = calib.prior_pos
    mass = (p * (calib.pdf_pos.cdf(r) - calib.pdf_pos.cdf(l))
            + (1 - p) * (calib.pdf_neg.cdf(r) - calib.pdf_neg.cdf(l)))
    return float(max(mass, 0.0))


def select_thresholds(calib: Calibration, alpha: float,
                      metric: str = "f1",
                      margin: float = 0.0) -> ThresholdResult:
    """Linear frontier walk (Algorithm 2). ``margin`` tightens the
    constraint to Acc >= alpha + margin (Bernstein safety, §4.4)."""
    steps = calib.edges
    B = len(steps) - 1
    target = alpha + margin

    def acc(l, r):
        return accuracy_est(calib, l, r, metric)

    l_s, r_s = steps[0], steps[-1]
    if acc(l_s, r_s) < target:
        # even all-oracle cannot certify per the estimate (possible when
        # the prior estimate itself is off) -> send everything to oracle
        return ThresholdResult(l_s, r_s, 1.0, acc(l_s, r_s), False)

    # 1. tightest l0 with r = r_s
    i_l0 = 0
    for i in range(1, B + 1):
        if acc(steps[i], r_s) >= target:
            i_l0 = i
        else:
            break
    # 2. staircase walk from (l0, r_s) toward (l_s, r0)
    best = (unfiltered_est(calib, steps[i_l0], r_s), i_l0, B)
    il, ir = i_l0, B
    path = 1
    while ir > 0:
        if il > 0 and acc(steps[il], steps[ir - 1]) < target:
            il -= 1           # loosen l to regain slack
        else:
            if acc(steps[il], steps[ir - 1]) < target:
                break          # even l = l_s cannot support tighter r
            ir -= 1            # tighten r
        path += 1
        u = unfiltered_est(calib, steps[il], steps[ir])
        if u < best[0]:
            best = (u, il, ir)
    u, il, ir = best
    return ThresholdResult(float(steps[il]), float(steps[ir]), u,
                           acc(steps[il], steps[ir]), True, path)


def bootstrap_certify(sample_scores: np.ndarray, sample_labels: np.ndarray,
                      l: float, r: float, alpha: float, metric: str,
                      n_boot: int, conf: float,
                      rng: np.random.Generator) -> bool:
    """Resample the calibration sample; the pair (l, r) is certified when
    >= conf of resamples meet the accuracy target (oracle-perfect band)."""
    n = len(sample_scores)
    if n == 0:
        return False
    labels = sample_labels.astype(bool)
    ok = 0
    for _ in range(n_boot):
        idx = rng.integers(0, n, size=n)
        s, y = sample_scores[idx], labels[idx]
        fn = int(np.sum(y & (s < l)))
        fp = int(np.sum(~y & (s > r)))
        tp = int(y.sum()) - fn
        if metric == "exact":
            acc = 1.0 - (fp + fn) / n
        else:
            denom = 2 * tp + fp + fn
            acc = 2 * tp / denom if denom else 1.0
        ok += acc >= alpha
    return ok >= conf * n_boot


def select_thresholds_certified(calib: Calibration, alpha: float,
                                metric: str = "f1",
                                n_boot: int = 64, conf: float = 0.9,
                                max_margin: float = 0.08,
                                rng: Optional[np.random.Generator] = None
                                ) -> ThresholdResult:
    """Widen the selection target until the bootstrap certifies the chosen
    thresholds on the calibration sample (the robustness layer behind the
    paper's Fig. 12a accuracy-maintenance results)."""
    rng = rng or np.random.default_rng(0)
    if calib.sample_scores is None:
        raise ValueError("Calibration missing raw sample scores")
    margin = 0.0
    sel = select_thresholds(calib, alpha, metric, margin)
    while margin <= max_margin:
        sel = select_thresholds(calib, alpha, metric, margin)
        if not sel.feasible:
            break
        if bootstrap_certify(calib.sample_scores, calib.sample_labels,
                             sel.l, sel.r, alpha, metric, n_boot, conf, rng):
            return sel
        margin += 0.01
    return sel


def brute_force_thresholds(calib: Calibration, alpha: float,
                           metric: str = "f1",
                           margin: float = 0.0) -> ThresholdResult:
    """O(B^2) exhaustive reference (correctness oracle for Algorithm 2)."""
    steps = calib.edges
    target = alpha + margin
    best: Optional[Tuple[float, int, int]] = None
    for i in range(len(steps)):
        for j in range(i, len(steps)):
            if accuracy_est(calib, steps[i], steps[j], metric) >= target:
                u = unfiltered_est(calib, steps[i], steps[j])
                if best is None or u < best[0]:
                    best = (u, i, j)
    if best is None:
        return ThresholdResult(steps[0], steps[-1], 1.0,
                               accuracy_est(calib, steps[0], steps[-1],
                                            metric), False)
    u, i, j = best
    return ThresholdResult(float(steps[i]), float(steps[j]), u,
                           accuracy_est(calib, steps[i], steps[j], metric),
                           True)


def oracle_optimal_thresholds(scores: np.ndarray, labels: np.ndarray,
                              edges: np.ndarray, alpha: float,
                              metric: str = "f1") -> ThresholdResult:
    """Brute-force optimum computed on *ground-truth* labels: the
    'brute-force optimal cascade' of the paper's Fig. 9 ablation."""
    labels = labels.astype(bool)
    n = len(scores)
    best = None
    for i in range(len(edges)):
        for j in range(i, len(edges)):
            l, r = edges[i], edges[j]
            auto_pos = scores > r
            auto_neg = scores < l
            fp = int(np.sum(auto_pos & ~labels))
            fn = int(np.sum(auto_neg & labels))
            tp = int(labels.sum()) - fn
            if metric == "exact":
                acc = 1.0 - (fp + fn) / max(n, 1)
            else:
                acc = 2 * tp / max(2 * tp + fp + fn, 1)
            if acc >= alpha:
                u = float(np.mean(~auto_pos & ~auto_neg))
                if best is None or u < best[0]:
                    best = (u, l, r, acc)
    if best is None:
        return ThresholdResult(0.0, 1.0, 1.0, 0.0, False)
    u, l, r, acc = best
    return ThresholdResult(float(l), float(r), u, float(acc), True)
