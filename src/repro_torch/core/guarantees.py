"""Theoretical accuracy guarantee (paper §4.4, Proposition 1).

Bernstein concentration of the weighted error functional
  Z_i = (1 - a/2) 1[pos & s_i < l] + (a/2) 1[neg & s_i > r]
gives a safety margin eps such that, if the *sample* satisfies
  T_S'(l, r) <= (1 - a) F+_S' - eps,
then the *population* accuracy exceeds alpha w.p. >= 1 - delta.

  eps = (sqrt(var_Z) + (1-a) sqrt(var_P)) * sqrt(4 ln(4/delta) / (pN))
        + (8 - 6a) ln(4/delta) / (3 pN)
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GuaranteeReport:
    epsilon: float
    t_sample: float      # T_S'(l, r)
    rhs: float           # (1 - alpha) F+_S'
    certified: bool      # t_sample <= rhs - epsilon


def _z_values(scores: np.ndarray, labels: np.ndarray, l: float, r: float,
              alpha: float) -> np.ndarray:
    pos = labels.astype(bool)
    z = np.zeros(len(scores))
    z += (1 - alpha / 2) * (pos & (scores < l))
    z += (alpha / 2) * (~pos & (scores > r))
    return z


def bernstein_epsilon(var_z: float, var_p: float, alpha: float,
                      delta: float, n_sample: int) -> float:
    n = max(n_sample, 1)
    log_term = np.log(4.0 / delta)
    eps = ((np.sqrt(max(var_z, 0.0)) + (1 - alpha) * np.sqrt(max(var_p, 0.0)))
           * np.sqrt(4.0 * log_term / n)
           + (8 - 6 * alpha) * log_term / (3.0 * n))
    return float(eps)


def check_guarantee(sample_scores: np.ndarray, sample_labels: np.ndarray,
                    l: float, r: float, alpha: float,
                    delta: float) -> GuaranteeReport:
    """Proposition 1's sample condition for thresholds (l, r)."""
    n = len(sample_scores)
    labels = sample_labels.astype(bool)
    z = _z_values(sample_scores, labels, l, r, alpha)
    t_sample = float(z.mean()) if n else 0.0
    f_pos = float(labels.mean()) if n else 0.0
    var_z = float(z.var()) if n else 0.0
    var_p = float(labels.astype(float).var()) if n else 0.0
    eps = bernstein_epsilon(var_z, var_p, alpha, delta, n)
    rhs = (1 - alpha) * f_pos
    return GuaranteeReport(epsilon=eps, t_sample=t_sample, rhs=rhs,
                           certified=t_sample <= rhs - eps)


def accuracy_margin_for_selection(sample_scores: np.ndarray,
                                  sample_labels: np.ndarray,
                                  alpha: float, delta: float) -> float:
    """A conservative uplift on the selection target: pick thresholds
    against alpha' = alpha + margin so the certified condition holds with
    slack. Uses worst-case variances (bounded by Bernoulli 1/4 scaled)."""
    n = max(len(sample_scores), 1)
    var_p = float(sample_labels.astype(float).var()) if n else 0.25
    # var_z bounded by (1 - alpha/2)^2 / 4 in the worst case
    var_z = (1 - alpha / 2) ** 2 * 0.25
    eps = bernstein_epsilon(var_z, var_p, alpha, delta, n)
    # translate the T-functional margin into an accuracy-target uplift:
    # d(Acc)/d(T) ~ -2 near the operating point, so uplift ~ 2 eps,
    # clipped to keep the target < 1.
    return float(min(2.0 * eps, 0.5 * (1.0 - alpha)))
