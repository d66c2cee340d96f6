"""Ad-hoc calibration (paper §4.2, Algorithm 1).

From the proxy's decision scores over the full collection and a small
oracle-labeled sample, reconstruct the class-conditional score
distributions:

  1. Discretize [0, 1] into `num_bins` bins.
  2. Stratified sampling: sample from each bin proportionally to its
     population, so low-density regions are represented.
  3. Oracle-label the sample; split scores into positive / negative sets.
  4. Jitter: inject low-density mass into empty bins (information
     recovery — empty bins must not read as "certainly zero").
  5. Density estimation via *linear interpolation* of bin masses
     (distortion-free vs KDE, per the paper).
  6. Moving-average smoothing to suppress sampling noise.

Outputs piecewise-linear PDFs/CDFs for both classes plus the estimated
positive prior — everything threshold selection (Algorithm 2) needs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.config import CascadeConfig


@dataclasses.dataclass
class ClassDensity:
    """Piecewise-linear density over score bins."""
    edges: np.ndarray       # (B+1,)
    centers: np.ndarray     # (B,)
    pdf: np.ndarray         # (B,) density at centers (integrates to ~1)
    cdf_edges: np.ndarray   # (B+1,) CDF evaluated at edges

    def cdf(self, x) -> np.ndarray:
        return np.interp(x, self.edges, self.cdf_edges)


@dataclasses.dataclass
class Calibration:
    pdf_pos: ClassDensity
    pdf_neg: ClassDensity
    prior_pos: float          # F^+ (fraction of positives)
    edges: np.ndarray         # discretization (steps of Algorithm 2)
    sample_idx: np.ndarray    # labeled sample indices (oracle calls)
    sample_labels: np.ndarray
    sample_scores: np.ndarray = None


def discretize(num_bins: int) -> np.ndarray:
    return np.linspace(0.0, 1.0, num_bins + 1)


def stratified_sample(scores: np.ndarray, frac: float, edges: np.ndarray,
                      rng: np.random.Generator) -> np.ndarray:
    """Proportional per-bin sampling without replacement. Returns indices."""
    n = len(scores)
    target = max(int(np.ceil(frac * n)), 8)
    bin_ids = np.clip(np.searchsorted(edges, scores, side="right") - 1,
                      0, len(edges) - 2)
    chosen = []
    for b in range(len(edges) - 1):
        members = np.nonzero(bin_ids == b)[0]
        if len(members) == 0:
            continue
        take = int(round(target * len(members) / n))
        take = max(take, 1) if len(members) > 0 else 0
        take = min(take, len(members))
        chosen.append(rng.choice(members, size=take, replace=False))
    idx = np.concatenate(chosen) if chosen else np.array([], np.int64)
    rng.shuffle(idx)
    return idx


def _hist_density(scores: np.ndarray, edges: np.ndarray) -> np.ndarray:
    counts, _ = np.histogram(scores, bins=edges)
    return counts.astype(np.float64)


def _jitter(mass: np.ndarray, density: float,
            rng: np.random.Generator) -> np.ndarray:
    """Inject low random mass into empty bins (Algorithm 1 step 1)."""
    total = mass.sum()
    if total <= 0:
        return mass
    empty = mass == 0
    if not empty.any():
        return mass
    inj = rng.uniform(0.5, 1.5, size=int(empty.sum())) * density * total \
        / max(len(mass), 1)
    out = mass.copy()
    out[empty] = inj
    return out


def _moving_average(x: np.ndarray, window: int) -> np.ndarray:
    if window <= 1:
        return x
    kernel = np.ones(window) / window
    pad = window // 2
    xp = np.pad(x, (pad, pad), mode="edge")
    out = np.convolve(xp, kernel, mode="valid")
    return out[:len(x)]


def _density_from_mass(mass: np.ndarray, edges: np.ndarray) -> ClassDensity:
    centers = 0.5 * (edges[:-1] + edges[1:])
    width = np.diff(edges)
    total = mass.sum()
    pdf = (mass / total) / width if total > 0 else np.zeros_like(mass)
    # CDF at edges by integrating the piecewise-linear pdf over bins
    # (equivalently: cumulative normalized mass)
    cdf = np.concatenate([[0.0], np.cumsum(mass / max(total, 1e-12))])
    cdf = np.clip(cdf, 0.0, 1.0)
    cdf[-1] = 1.0
    return ClassDensity(edges=edges, centers=centers, pdf=pdf,
                        cdf_edges=cdf)


def reconstruct_density(sample_scores: np.ndarray, edges: np.ndarray,
                        cfg: CascadeConfig,
                        rng: np.random.Generator) -> ClassDensity:
    """Jitter -> linear-interp DE -> moving-average smoothing."""
    mass = _hist_density(sample_scores, edges)
    mass = _jitter(mass, cfg.jitter_density, rng)
    mass = _moving_average(mass, cfg.ma_window)
    return _density_from_mass(mass, edges)


def calibrate(scores: np.ndarray, oracle_label_fn: Callable,
              cfg: CascadeConfig,
              rng: Optional[np.random.Generator] = None) -> Calibration:
    """Algorithm 1. ``oracle_label_fn(indices) -> labels`` (counted by the
    caller's oracle object)."""
    rng = rng or np.random.default_rng(cfg.seed)
    edges = discretize(cfg.num_bins)
    idx = stratified_sample(scores, cfg.calib_fraction, edges, rng)
    labels = np.asarray(oracle_label_fn(idx)).astype(bool)
    s = scores[idx]
    pos_scores, neg_scores = s[labels], s[~labels]
    pdf_pos = reconstruct_density(pos_scores, edges, cfg, rng)
    pdf_neg = reconstruct_density(neg_scores, edges, cfg, rng)
    prior = float(labels.mean()) if len(labels) else 0.5
    return Calibration(pdf_pos=pdf_pos, pdf_neg=pdf_neg, prior_pos=prior,
                       edges=edges, sample_idx=idx, sample_labels=labels,
                       sample_scores=s)


# -- alternative density estimators (baselines, the Table 4 ablation) ------

def naive_density(sample_scores: np.ndarray, edges: np.ndarray
                  ) -> ClassDensity:
    """No jitter, no smoothing (the 'Naive'/'w/o Jitter' baselines)."""
    return _density_from_mass(_hist_density(sample_scores, edges), edges)


def beta_fit_density(sample_scores: np.ndarray, edges: np.ndarray
                     ) -> ClassDensity:
    """Method-of-moments Beta fit (Table 4 'B')."""
    s = np.clip(sample_scores, 1e-4, 1 - 1e-4)
    if len(s) < 2:
        return naive_density(sample_scores, edges)
    m, v = float(s.mean()), float(max(s.var(), 1e-6))
    common = m * (1 - m) / v - 1
    a, b = max(m * common, 0.05), max((1 - m) * common, 0.05)
    centers = 0.5 * (edges[:-1] + edges[1:])
    # unnormalized Beta pdf evaluated at centers
    logpdf = (a - 1) * np.log(centers + 1e-12) \
        + (b - 1) * np.log(1 - centers + 1e-12)
    logpdf -= logpdf.max()
    mass = np.exp(logpdf)
    return _density_from_mass(mass, edges)


def importance_density(sample_scores: np.ndarray, weights: np.ndarray,
                       edges: np.ndarray) -> ClassDensity:
    """Importance-weighted histogram (Table 4 'IS')."""
    counts, _ = np.histogram(sample_scores, bins=edges, weights=weights)
    return _density_from_mass(counts.astype(np.float64), edges)
