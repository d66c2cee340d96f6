"""Two-phase contrastive training of the query-aware proxy (paper §3.2, §5).

Given a small oracle-labelled sample of document embeddings, trains the
lightweight encoder:
  Phase 1: L_qsim only                     -> semantic monotonicity
  Phase 2: lam*L_supcon + (1-lam)*L_polar  -> bipolarity
with fallback-style rebalancing of a skewed sample (Gaussian-noised
copies of the minority class), Gaussian augmentation of every batch, a
projector head used only here, and the hand-rolled AdamW of
``repro_torch.optimizer.adamw`` (warmup 5, cosine, clip 1.0).

``train_proxy_multi`` trains Q proxies at once over a written-out
leading lane axis (the JAX package vmaps its scanned trainer): every
leaf of the params carries that axis, the losses return one value per
lane, each lane is clipped by its own norm, and phase 2 runs the
contrastive kernel once per step for all lanes. Ragged samples are
zero-padded to a shared power-of-two bucket and a per-lane ``n_valid``
bounds the batch indices, so padding never changes results.

Random draws. The JAX package draws its init, batch indices and noise
from threefry keys, which torch cannot reproduce. So every draw of a run
is explicit: a ``DrawPlan`` holds the initial params, the ``rebalance``
seeds, and per-step batch indices and standard-normal noise. Without a
plan, each lane draws its own from ``torch.Generator``s seeded by its
seed alone, so a lane's result never depends on its siblings.

The paper's ablation variants (``train_proxy_variant``: phase 1 only,
either phase-2 objective alone, the full objective, or a plain MLP
binary classifier) are config rewrites of the same step loop, or its
BCE kind.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import OptimizerConfig, ProxyConfig
from repro_torch.core import losses
from repro_torch.core.encoder import (Params, encoder_apply, encoder_init,
                                      gelu, projector_apply, tree_leaves,
                                      tree_map)
from repro_torch.device import resolve_device
from repro_torch.kernels.contrastive import ops as contrastive_ops
from repro_torch.models.common import dense_init
from repro_torch.optimizer import adamw


class ProxyTrainResult(NamedTuple):
    params: Dict
    phase1_losses: np.ndarray
    phase2_losses: np.ndarray


class ProxyTrainResultMulti(NamedTuple):
    """Q proxies trained together. ``params`` leaves carry a leading
    (Q,) axis; use :func:`unstack_params` for per-proxy trees."""
    params: Dict
    phase1_losses: np.ndarray   # (Q, phase1_steps)
    phase2_losses: np.ndarray   # (Q, phase2_steps)


@dataclasses.dataclass
class DrawPlan:
    """Every random draw of a training run of Q lanes.

    params:          stacked initial params, each leaf (Q, ...).
    rebalance_seeds: (Q,) numpy seeds handed to :func:`rebalance`.
    idx:             (Q, T, batch) batch indices, each in [0, n_valid).
    noise:           (Q, T, batch, D) standard normals; the batch gets
                     ``aug_noise * noise`` added.
    """
    params: Params
    rebalance_seeds: Sequence[int]
    idx: np.ndarray
    noise: np.ndarray


def rebalance(seed: int, embeds: np.ndarray, labels: np.ndarray,
              cfg: ProxyConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Fallback rebalancing: Gaussian-noise augmentation of the minority,
    drawn from ``np.random.default_rng(seed)``."""
    labels = labels.astype(np.int32)
    n = len(labels)
    n_pos = int(labels.sum())
    n_neg = n - n_pos
    if n == 0 or min(n_pos, n_neg) >= cfg.rebalance_min_frac * n:
        return embeds, labels
    if n_pos == 0 or n_neg == 0:
        # degenerate sample: nothing to mirror — caller handles
        return embeds, labels
    minority = 1 if n_pos < n_neg else 0
    src = embeds[labels == minority]
    need = int(cfg.rebalance_min_frac * n) - len(src)
    if need <= 0:
        return embeds, labels
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(src), size=need)
    noise = rng.normal(0.0, cfg.rebalance_noise, size=(need, embeds.shape[1]))
    aug = src[idx] + noise.astype(embeds.dtype)
    embeds = np.concatenate([embeds, aug], axis=0)
    labels = np.concatenate([labels, np.full(need, minority, labels.dtype)])
    return embeds, labels


def _bucket(n: int) -> int:
    """Pad target for the labelled sample: next power of two (>= 64)."""
    m = 64
    while m < n:
        m *= 2
    return m


def _pad_sample(embeds: np.ndarray, labels: np.ndarray,
                pad_to: int) -> Tuple[np.ndarray, np.ndarray, int]:
    n = embeds.shape[0]
    if n < pad_to:
        embeds = np.concatenate(
            [embeds, np.zeros((pad_to - n, embeds.shape[1]), embeds.dtype)])
        labels = np.concatenate([labels, np.zeros(pad_to - n, labels.dtype)])
    return (np.asarray(embeds, np.float32), labels.astype(np.float32), n)


def _proxy_opt_cfg(cfg: ProxyConfig, weight_decay: Optional[float] = None
                   ) -> OptimizerConfig:
    wd = cfg.weight_decay if weight_decay is None else weight_decay
    return OptimizerConfig(lr=cfg.lr, warmup_steps=5,
                           total_steps=cfg.phase1_steps + cfg.phase2_steps,
                           schedule="cosine", weight_decay=wd,
                           grad_clip=1.0)


def _project(params: Params, x: torch.Tensor) -> torch.Tensor:
    return projector_apply(params, encoder_apply(params, x))


def _loss_phase1(params, e_qs, xb, yb, cfg: ProxyConfig) -> torch.Tensor:
    zq = _project(params, e_qs.unsqueeze(1)).squeeze(1)
    return losses.phase1_loss(zq, _project(params, xb), yb,
                              cfg.temperature, cfg.qsim_variant)


def _loss_phase2(params, e_qs, xb, yb, cfg: ProxyConfig) -> torch.Tensor:
    zq = _project(params, e_qs.unsqueeze(1)).squeeze(1)
    return contrastive_ops.phase2_loss(zq, _project(params, xb), yb,
                                       cfg.temperature, cfg.lambda_supcon)


def _mlp_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The classifier baseline's logits; a stacked tree (lane axis first)
    applies lane by lane to a (Q, n, D) input."""
    lanes = params["w1"].dim() == 3
    bias = (lambda b: b.unsqueeze(-2)) if lanes else (lambda b: b)
    h = gelu(x @ params["w1"] + bias(params["b1"]))
    h = gelu(h @ params["w2"] + bias(params["b2"]))
    return (h @ params["w3"] + bias(params["b3"]))[..., 0]


def _loss_mlp(params, e_qs, xb, yb, cfg: ProxyConfig) -> torch.Tensor:
    """Binary cross-entropy on logits, one value per lane."""
    del e_qs
    logit = _mlp_logits(params, xb)
    return torch.mean(torch.clamp(logit, min=0) - logit * yb
                      + torch.log1p(torch.exp(-logit.abs())), dim=-1)


# kind -> (phase-1 loss, phase-2 loss, Gaussian batch augmentation)
_KINDS = {
    "two_phase": (_loss_phase1, _loss_phase2, True),
    "mlp": (_loss_mlp, _loss_mlp, False),
}


def stack_params(trees: Sequence[Params]) -> Params:
    """Q param trees -> one tree whose leaves carry a leading (Q,) axis."""
    if isinstance(trees[0], dict):
        return {k: stack_params([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(list(trees))


def unstack_params(stacked: Params) -> List[Params]:
    """Split a ``train_proxy_multi`` stacked param tree into Q trees."""
    q = tree_leaves(stacked)[0].shape[0]
    return [tree_map(lambda x: x[i], stacked) for i in range(q)]


def _own_draws(seeds: Sequence[int], cfg: ProxyConfig):
    """Each lane's initial params, rebalance seed, batch-index generator
    and noise seed, from a CPU generator seeded by the lane's seed alone."""
    gens = [torch.Generator().manual_seed(int(s)) for s in seeds]
    params = stack_params([encoder_init(g, cfg) for g in gens])
    seed_of = lambda g: int(torch.randint(0, 2 ** 31 - 1, (1,), generator=g))
    rb = [seed_of(g) for g in gens]
    noise_seeds = [seed_of(g) for g in gens]
    return params, rb, gens, noise_seeds


def train_proxy_multi(seeds: Sequence[int], e_qs, samples: Sequence,
                      labels: Sequence, cfg: ProxyConfig, *,
                      plan: Optional[DrawPlan] = None,
                      device="cuda") -> ProxyTrainResultMulti:
    """Train Q independent proxies together.

    seeds: Q ints (ignored where ``plan`` gives the draws); e_qs: (Q, D)
    query embeddings; samples[i]: (n_i, D) labelled embeddings;
    labels[i]: (n_i,) {0,1}. Returns params on ``device``.
    """
    dev = resolve_device(device)
    q = len(samples)
    if not (q == len(labels) == len(seeds)):
        raise ValueError("seeds, samples and labels must have one entry "
                         "per lane")
    if plan is None:
        params0, rb_seeds, gens, noise_seeds = _own_draws(seeds, cfg)
    else:
        params0, rb_seeds = plan.params, list(plan.rebalance_seeds)
    balanced = []
    for i, (s, y) in enumerate(zip(samples, labels)):
        e_np, y_np = np.asarray(s, np.float32), np.asarray(y)
        if cfg.rebalance:
            e_np, y_np = rebalance(rb_seeds[i], e_np, y_np, cfg)
        balanced.append((e_np, y_np))
    pad_to = _bucket(max(e.shape[0] for e, _ in balanced))
    n_valid = [e.shape[0] for e, _ in balanced]
    padded = [_pad_sample(e, y, pad_to) for e, y in balanced]
    embeds_d = torch.as_tensor(np.stack([p[0] for p in padded]), device=dev)
    labels_d = torch.as_tensor(np.stack([p[1] for p in padded]), device=dev)
    e_qs = torch.as_tensor(np.asarray(e_qs, np.float32), device=dev)

    total, bs = cfg.phase1_steps + cfg.phase2_steps, cfg.batch_size
    if plan is None:
        idx = torch.stack([torch.randint(0, nv, (total, bs), generator=g)
                           for nv, g in zip(n_valid, gens)]).to(dev)
        noise_gens = [torch.Generator(dev).manual_seed(s)
                      for s in noise_seeds]
        noise_at = lambda t, shape: torch.stack([
            torch.randn(shape, generator=g, device=dev)
            for g in noise_gens])
    else:
        idx = torch.as_tensor(np.asarray(plan.idx), dtype=torch.long,
                              device=dev)
        noise_all = torch.as_tensor(np.asarray(plan.noise, np.float32),
                                    device=dev)
        noise_at = lambda t, shape: noise_all[:, t]
    _check_idx(idx, n_valid, q, total, bs)
    return _fit(params0, e_qs, embeds_d, labels_d, idx, noise_at, cfg,
                _proxy_opt_cfg(cfg), "two_phase")


def _check_idx(idx: torch.Tensor, n_valid: Sequence[int], q: int,
               total: int, bs: int) -> None:
    if idx.shape != (q, total, bs):
        raise ValueError(f"batch indices have shape {tuple(idx.shape)}, "
                         f"expected {(q, total, bs)}")
    bound = torch.tensor(n_valid, device=idx.device).reshape(q, 1, 1)
    if bool(((idx < 0) | (idx >= bound)).any()):
        raise ValueError("batch indices must lie in [0, n_valid) of their "
                         f"lane; n_valid = {n_valid}")


def _fit(params0: Params, e_qs: torch.Tensor, embeds_d: torch.Tensor,
         labels_d: torch.Tensor, idx: torch.Tensor, noise_at,
         cfg: ProxyConfig, opt_cfg: OptimizerConfig,
         kind: str) -> ProxyTrainResultMulti:
    """The step loop over Q lanes: ``phase1_steps`` steps of the kind's
    phase-1 loss, then ``phase2_steps`` of its phase-2 loss, each on the
    batch ``idx[:, t]`` (plus ``aug_noise * noise_at(t, shape)`` where the
    kind augments)."""
    loss1, loss2, use_aug = _KINDS[kind]
    dev = embeds_d.device
    q = embeds_d.shape[0]
    params = tree_map(lambda p: torch.tensor(
        np.asarray(p, np.float32) if not isinstance(p, torch.Tensor)
        else p.detach().cpu().numpy(), device=dev).requires_grad_(True),
        params0)
    opt_state = adamw.init(params)
    lanes = torch.arange(q, device=dev).unsqueeze(1)
    trace = []
    for t in range(cfg.phase1_steps + cfg.phase2_steps):
        loss_fn = loss1 if t < cfg.phase1_steps else loss2
        it = idx[:, t]
        xb = embeds_d[lanes, it]                         # (Q, bs, D)
        yb = labels_d[lanes, it]                         # (Q, bs)
        if use_aug and cfg.aug_noise > 0:
            xb = xb + cfg.aug_noise * noise_at(t, xb.shape[1:])
        loss = loss_fn(params, e_qs, xb, yb, cfg)        # (Q,)
        leaves = tree_leaves(params)
        grads_flat = torch.autograd.grad(loss.sum(), leaves)
        grads = _like(params, grads_flat)
        params, opt_state = adamw.update(opt_cfg, params, grads, opt_state,
                                         lanes=True)
        params = tree_map(lambda p: p.requires_grad_(True), params)
        trace.append(loss.detach())
    params = tree_map(lambda p: p.detach(), params)
    trace = torch.stack(trace, dim=1).cpu().numpy() if trace else \
        np.zeros((q, 0), np.float32)
    return ProxyTrainResultMulti(params, trace[:, :cfg.phase1_steps],
                                 trace[:, cfg.phase1_steps:])


def _like(tree: Params, flat: Sequence[torch.Tensor]) -> Params:
    """Rebuild ``tree``'s structure from leaves in ``tree_leaves`` order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def train_proxy(seed: int, e_q, embeds, labels, cfg: ProxyConfig, *,
                plan: Optional[DrawPlan] = None,
                device="cuda") -> ProxyTrainResult:
    """Train one proxy on an oracle-labelled sample: the one-lane case of
    :func:`train_proxy_multi` (``plan``, if given, has Q=1).

    e_q: (D,) query embedding; embeds: (n, D); labels: (n,) {0,1}.
    """
    res = train_proxy_multi([seed], np.asarray(e_q, np.float32)[None],
                            [embeds], [labels], cfg, plan=plan,
                            device=device)
    return ProxyTrainResult(unstack_params(res.params)[0],
                            res.phase1_losses[0], res.phase2_losses[0])


def train_proxy_variant(seed: int, e_q, embeds, labels, cfg: ProxyConfig,
                        variant: str, *, plan: Optional[DrawPlan] = None,
                        device="cuda") -> Dict:
    """Ablation variants for the paper's Fig. 9/11: ``"qsim"`` (phase 1
    only), ``"qsim+supcon"``, ``"qsim+polar"``, ``"full"``, or ``"mlp"``
    (a binary classifier; score it with :func:`mlp_classifier_scores`).

    The partial objectives are config rewrites of the same trainer with
    rebalancing off, as in the original ablation setup: ``"qsim"`` runs
    every step on the phase-1 loss (no contrastive launch), and the two
    phase-2 objectives alone are ``lambda_supcon`` 1.0 and 0.0. ``plan``
    (Q=1) gives the run's draws, as for :func:`train_proxy`.
    """
    if variant == "full":
        return train_proxy(seed, e_q, embeds, labels, cfg, plan=plan,
                           device=device).params
    if variant == "mlp":
        return _train_mlp_classifier(seed, embeds, labels, cfg, plan=plan,
                                     device=device)
    rewrites = {
        "qsim": dict(phase1_steps=cfg.phase1_steps + cfg.phase2_steps,
                     phase2_steps=0),
        "qsim+supcon": dict(lambda_supcon=1.0),
        "qsim+polar": dict(lambda_supcon=0.0),
    }
    if variant not in rewrites:
        raise ValueError(f"unknown variant {variant!r}")
    cfg_v = dataclasses.replace(cfg, rebalance=False, **rewrites[variant])
    return train_proxy(seed, e_q, embeds, labels, cfg_v, plan=plan,
                       device=device).params


def _train_mlp_classifier(seed: int, embeds, labels, cfg: ProxyConfig, *,
                          plan: Optional[DrawPlan] = None,
                          device="cuda") -> Dict:
    """Baseline: a plain MLP binary classifier on embeddings (paper Fig.
    9 'MLP'), trained by the same step loop with the BCE loss, no
    augmentation, no rebalancing and no weight decay, for ``phase1_steps
    + phase2_steps`` steps. Returns single (unstacked) params for
    :func:`mlp_classifier_scores`.

    ``plan`` (Q=1) gives the initial params ``{w1, b1, w2, b2, w3, b3}``
    (each with a leading lane axis of 1) and the batch indices; its
    rebalance seeds and noise are unused. Without it, params and indices
    come from a ``torch.Generator`` seeded by ``seed``.
    """
    dev = resolve_device(device)
    total, bs = cfg.phase1_steps + cfg.phase2_steps, cfg.batch_size
    e_np = np.asarray(embeds, np.float32)
    e_pad, y_pad, n_valid = _pad_sample(e_np, np.asarray(labels),
                                        _bucket(e_np.shape[0]))
    if plan is None:
        gen = torch.Generator().manual_seed(int(seed))
        d, h = cfg.embed_dim, cfg.hidden_dim
        params0 = {"w1": dense_init(gen, d, (h,)), "b1": torch.zeros(h),
                   "w2": dense_init(gen, h, (h,)), "b2": torch.zeros(h),
                   "w3": dense_init(gen, h, (1,)), "b3": torch.zeros(1)}
        params0 = tree_map(lambda p: p.unsqueeze(0), params0)
        idx = torch.randint(0, n_valid, (1, total, bs), generator=gen)
    else:
        params0 = plan.params
        idx = torch.as_tensor(np.asarray(plan.idx), dtype=torch.long)
    idx = idx.to(dev)
    _check_idx(idx, [n_valid], 1, total, bs)
    res = _fit(params0, torch.zeros((1, e_np.shape[1]), device=dev),
               torch.as_tensor(e_pad[None], device=dev),
               torch.as_tensor(y_pad[None], device=dev), idx, None, cfg,
               _proxy_opt_cfg(cfg, weight_decay=0.0), "mlp")
    return unstack_params(res.params)[0]


def mlp_classifier_scores(params: Dict, embeds) -> torch.Tensor:
    """Sigmoid of the classifier's logits: (N,) on ``params``' device."""
    w1 = params["w1"]
    x = torch.as_tensor(np.asarray(embeds, np.float32)
                        if not isinstance(embeds, torch.Tensor) else embeds,
                        device=w1.device)
    return torch.sigmoid(_mlp_logits(params, x))
