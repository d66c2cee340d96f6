"""End-to-end adaptive cascade (paper §4): calibrate -> select thresholds
-> filter -> oracle the ambiguous band.

The cascade consumes decision scores from *any* proxy (our trained
encoder, an MLP classifier, raw embedding matching, or an LLM's logprobs)
— that pluggability is what the paper's §6.5 cascade ablations rely on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.config import CascadeConfig
from repro_torch.core import calibration as calib_mod
from repro_torch.core import thresholds as thr_mod
from repro_torch.core.guarantees import accuracy_margin_for_selection, check_guarantee


@dataclasses.dataclass
class CascadeResult:
    labels: np.ndarray          # final binary decisions for all docs
    l: float
    r: float
    unfiltered_rate: float      # fraction sent to the oracle (online phase)
    oracle_calls_online: int    # oracle calls on the ambiguous band
    oracle_calls_calib: int     # oracle calls for calibration labels
    est_accuracy: float
    achieved_f1: Optional[float] = None
    achieved_exact: Optional[float] = None
    data_reduction: float = 0.0  # 1 - (all oracle calls) / N
    certified: Optional[bool] = None


@dataclasses.dataclass
class ThresholdSpec:
    """The calibration half of a threshold cascade: everything needed to
    decide any document later — thresholds, the labeled calibration
    sample (whose purchased labels the band resolution reuses), and the
    selection's quality estimates. Splitting this out of ``run_cascade``
    lets the engine calibrate a leaf once over the full collection and
    resolve only the ambiguous-band documents each query actually
    needs."""
    l: float
    r: float
    sample_idx: np.ndarray
    sample_labels: np.ndarray
    est_accuracy: float
    oracle_calls_calib: int
    certified: Optional[bool] = None


def f1_score(pred: np.ndarray, truth: np.ndarray) -> float:
    pred = pred.astype(bool)
    truth = truth.astype(bool)
    tp = int(np.sum(pred & truth))
    fp = int(np.sum(pred & ~truth))
    fn = int(np.sum(~pred & truth))
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 1.0


def resolve_ambiguous_band(scores: np.ndarray, l: float, r: float, oracle,
                           sample_idx, sample_labels
                           ) -> tuple:
    """Final labeling shared by every threshold-based strategy: auto-label
    outside (l, r), oracle the ambiguous band, reusing labels already
    purchased for the calibration/training sample.

    Returns (labels, ambiguous_mask, online_calls).
    """
    n = len(scores)
    auto_pos = scores > r
    ambiguous = ~(auto_pos | (scores < l))
    labels = np.zeros(n, bool)
    labels[auto_pos] = True
    known = {int(i): bool(lbl) for i, lbl in zip(sample_idx, sample_labels)}
    amb_idx = np.nonzero(ambiguous)[0]
    need = np.array([i for i in amb_idx if int(i) not in known],
                    dtype=np.int64)
    if len(need):
        labels[need] = oracle.label(need)
    for i in amb_idx:
        if int(i) in known:
            labels[i] = known[int(i)]
    return labels, ambiguous, len(need)


def calibrate_thresholds(scores: np.ndarray, oracle, cfg: CascadeConfig,
                         rng: Optional[np.random.Generator] = None
                         ) -> ThresholdSpec:
    """Calibrate + select thresholds over the full score vector — the
    oracle-sampling half of ``run_cascade``, with the band resolution
    left to the caller. Consumes ``rng`` in exactly the order
    ``run_cascade`` does, so composing it with
    ``resolve_ambiguous_band`` reproduces ``run_cascade`` bitwise."""
    rng = rng or np.random.default_rng(cfg.seed)
    calls_before = oracle.calls
    calib = calib_mod.calibrate(scores, oracle.label, cfg, rng)
    calib_calls = oracle.calls - calls_before

    mode = cfg.margin_mode
    if mode == "bootstrap":
        sel = thr_mod.select_thresholds_certified(
            calib, cfg.accuracy_target, metric=cfg.metric,
            n_boot=cfg.boot_samples, conf=cfg.boot_conf, rng=rng)
    else:
        margin = 0.0
        if mode == "bernstein":
            margin = accuracy_margin_for_selection(
                scores[calib.sample_idx], calib.sample_labels,
                cfg.accuracy_target, cfg.delta)
        sel = thr_mod.select_thresholds(calib, cfg.accuracy_target,
                                        metric=cfg.metric, margin=margin)

    guarantee = check_guarantee(scores[calib.sample_idx],
                                calib.sample_labels, sel.l, sel.r,
                                cfg.accuracy_target, cfg.delta)
    return ThresholdSpec(
        l=sel.l, r=sel.r, sample_idx=calib.sample_idx,
        sample_labels=calib.sample_labels, est_accuracy=sel.est_accuracy,
        oracle_calls_calib=calib_calls, certified=guarantee.certified)


def run_cascade(scores: np.ndarray, oracle, cfg: CascadeConfig,
                ground_truth: Optional[np.ndarray] = None,
                rng: Optional[np.random.Generator] = None) -> CascadeResult:
    """scores: (N,) proxy decision scores in [0, 1]; ``oracle.label(idx)``
    returns binary labels (and counts its own invocations)."""
    n = len(scores)
    spec = calibrate_thresholds(scores, oracle, cfg, rng)

    labels, ambiguous, online_calls = resolve_ambiguous_band(
        scores, spec.l, spec.r, oracle, spec.sample_idx,
        spec.sample_labels)

    result = CascadeResult(
        labels=labels, l=spec.l, r=spec.r,
        unfiltered_rate=float(ambiguous.mean()),
        oracle_calls_online=online_calls,
        oracle_calls_calib=spec.oracle_calls_calib,
        est_accuracy=spec.est_accuracy,
        data_reduction=1.0 - (online_calls + spec.oracle_calls_calib)
        / max(n, 1),
        certified=spec.certified,
    )
    if ground_truth is not None:
        truth = np.asarray(ground_truth).astype(bool)
        result.achieved_f1 = f1_score(labels, truth)
        result.achieved_exact = float(np.mean(labels == truth))
    return result


# -- baseline cascade strategies for §6.5 ------------------------------------

def naive_thresholds(scores: np.ndarray, oracle, cfg: CascadeConfig,
                     rng: Optional[np.random.Generator] = None
                     ) -> ThresholdSpec:
    """Calibration half of ``naive_cascade`` (raw empirical densities)."""
    rng = rng or np.random.default_rng(cfg.seed)
    n = len(scores)
    idx = rng.choice(n, size=max(int(cfg.calib_fraction * n), 8),
                     replace=False)
    labels_s = oracle.label(idx).astype(bool)
    calib_calls = len(idx)
    edges = calib_mod.discretize(cfg.num_bins)
    pdf_p = calib_mod.naive_density(scores[idx][labels_s], edges)
    pdf_n = calib_mod.naive_density(scores[idx][~labels_s], edges)
    calib = calib_mod.Calibration(pdf_pos=pdf_p, pdf_neg=pdf_n,
                                  prior_pos=float(labels_s.mean()),
                                  edges=edges, sample_idx=idx,
                                  sample_labels=labels_s)
    sel = thr_mod.select_thresholds(calib, cfg.accuracy_target,
                                    metric=cfg.metric)
    return ThresholdSpec(l=sel.l, r=sel.r, sample_idx=idx,
                         sample_labels=labels_s,
                         est_accuracy=sel.est_accuracy,
                         oracle_calls_calib=calib_calls)


def naive_cascade(scores: np.ndarray, oracle, cfg: CascadeConfig,
                  ground_truth=None) -> CascadeResult:
    """'Naive': thresholds straight from the raw sampled empirical
    distributions (no jitter / smoothing / stratification)."""
    spec = naive_thresholds(scores, oracle, cfg)
    return _finish(scores, oracle, spec, spec.oracle_calls_calib,
                   spec.sample_idx, spec.sample_labels, ground_truth)


def probe_cascade(scores: np.ndarray, oracle, cfg: CascadeConfig,
                  ground_truth=None, budget_frac: float = 0.5
                  ) -> CascadeResult:
    """'Probe-based calibration' (§6.5): iteratively oracle the most
    ambiguous documents (closest to 0.5) until the estimated accuracy of
    filtering the remainder meets the target."""
    n = len(scores)
    order = np.argsort(np.abs(scores - 0.5))
    labels = scores > 0.5
    step = max(n // 50, 8)
    probed = np.zeros(n, bool)
    spent = 0
    est = 0.0
    for k in range(step, int(budget_frac * n) + step, step):
        batch = order[spent:k]
        if not len(batch):
            break
        labels[batch] = oracle.label(batch)
        probed[batch] = True
        spent = k
        if spent >= n:
            break
        # the just-probed batch sits at the decision frontier, so the
        # proxy's agreement with the oracle there lower-bounds its
        # accuracy on the (easier) unprobed remainder
        proxy_right = np.mean((scores[batch] > 0.5) == labels[batch])
        est = proxy_right
        if proxy_right >= cfg.accuracy_target:
            break
    result = CascadeResult(
        labels=labels, l=0.0, r=1.0,
        unfiltered_rate=float(probed.mean()),
        oracle_calls_online=int(probed.sum()), oracle_calls_calib=0,
        est_accuracy=float(est),
        data_reduction=1.0 - probed.mean())
    if ground_truth is not None:
        truth = np.asarray(ground_truth).astype(bool)
        result.achieved_f1 = f1_score(labels, truth)
        result.achieved_exact = float(np.mean(labels == truth))
    return result


def supg_thresholds(scores: np.ndarray, oracle, cfg: CascadeConfig,
                    rng: Optional[np.random.Generator] = None
                    ) -> ThresholdSpec:
    """Calibration half of ``supg_cascade`` (importance-weighted CDF)."""
    rng = rng or np.random.default_rng(cfg.seed)
    n = len(scores)
    m = max(int(cfg.calib_fraction * n), 8)
    w = np.sqrt(np.clip(scores, 1e-3, None))
    p = w / w.sum()
    idx = rng.choice(n, size=m, replace=False, p=p)
    labels_s = oracle.label(idx).astype(bool)
    weights = 1.0 / (p[idx] * n)
    edges = calib_mod.discretize(cfg.num_bins)
    pdf_p = calib_mod.importance_density(scores[idx][labels_s],
                                         weights[labels_s], edges)
    pdf_n = calib_mod.importance_density(scores[idx][~labels_s],
                                         weights[~labels_s], edges)
    wsum = weights.sum()
    prior = float(weights[labels_s].sum() / wsum) if wsum > 0 else 0.5
    calib = calib_mod.Calibration(pdf_pos=pdf_p, pdf_neg=pdf_n,
                                  prior_pos=prior, edges=edges,
                                  sample_idx=idx, sample_labels=labels_s)
    sel = thr_mod.select_thresholds(calib, cfg.accuracy_target,
                                    metric=cfg.metric)
    return ThresholdSpec(l=sel.l, r=sel.r, sample_idx=idx,
                         sample_labels=labels_s,
                         est_accuracy=sel.est_accuracy,
                         oracle_calls_calib=m)


def supg_cascade(scores: np.ndarray, oracle, cfg: CascadeConfig,
                 ground_truth=None) -> CascadeResult:
    """SUPG-style (importance-sampled) threshold selection [Kang'20],
    approximated: importance sample ∝ sqrt(score) for recall-target-like
    behaviour, then select thresholds on the weighted empirical CDF."""
    spec = supg_thresholds(scores, oracle, cfg)
    return _finish(scores, oracle, spec, spec.oracle_calls_calib,
                   spec.sample_idx, spec.sample_labels, ground_truth)


def _finish(scores, oracle, sel, calib_calls, sample_idx, sample_labels,
            ground_truth) -> CascadeResult:
    n = len(scores)
    labels, ambiguous, online_calls = resolve_ambiguous_band(
        scores, sel.l, sel.r, oracle, sample_idx, sample_labels)
    result = CascadeResult(
        labels=labels, l=sel.l, r=sel.r,
        unfiltered_rate=float(ambiguous.mean()),
        oracle_calls_online=online_calls, oracle_calls_calib=calib_calls,
        est_accuracy=sel.est_accuracy,
        data_reduction=1.0 - (online_calls + calib_calls) / max(n, 1))
    if ground_truth is not None:
        truth = np.asarray(ground_truth).astype(bool)
        result.achieved_f1 = f1_score(labels, truth)
        result.achieved_exact = float(np.mean(labels == truth))
    return result
