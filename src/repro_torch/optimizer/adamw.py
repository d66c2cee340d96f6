"""Hand-rolled AdamW + LR schedules + global-norm clipping.

The update of ``repro.optimizer.adamw``, which differs from
``torch.optim.AdamW`` in three ways, all kept here:
  * gradients are clipped by their global norm first;
  * the learning rate is taken at ``step + 1``;
  * weight decay applies only to matrices (``ndim >= 2``).

State is ``{step, mu, nu}`` over the same dictionary tree as the params.
``apply_updates`` returns, beside the new params and state, the metrics
the LM training loop logs (``grad_norm`` before clipping, and ``lr``);
``update`` is the same step without them.
``lanes=True`` treats the leading axis of every leaf as independent
lanes (``train_proxy_multi``'s Q proxies): each lane is clipped by its
own global norm and a leaf's ``ndim`` is counted without that axis,
which is what ``jax.vmap`` of the reference update does. On DTensor
params and gradients (SPMD ranks, ``launch.mesh``) every step is
DTensor's: the global norm sums each leaf's squares over the whole
tensor (the shards' partial sums reduced) and comes out replicated, so
the clip, and every rank's update of its own shard, are the single
device's.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.config import OptimizerConfig
from repro_torch.core.encoder import tree_leaves, tree_map
from repro_torch.models.common import full_value


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def schedule(cfg: OptimizerConfig, step: int) -> float:
    """Warmup + {cosine, linear, constant} decay, in float32 as the
    reference computes it."""
    f32 = np.float32
    step = f32(step)
    warm = min(step / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    t = np.clip((step - f32(cfg.warmup_steps))
                / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                f32(0.0), f32(1.0))
    if cfg.schedule == "cosine":
        decay = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * t))
    elif cfg.schedule == "linear":
        decay = f32(1.0) - t
    else:
        decay = f32(1.0)
    return float(f32(cfg.lr) * warm * decay)


def init(cfg: OptimizerConfig, params: Any) -> AdamWState:
    """Step 0 and float32 zero moments shaped as ``params``; ``cfg`` is
    taken, as in the JAX package, and not read."""
    del cfg
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(step=0, mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params))


def global_norm(tree: Any, lanes: bool = False) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf; (Q,) with ``lanes``."""
    if lanes:
        sq = [x.float().square().flatten(1).sum(1) for x in tree_leaves(tree)]
    else:
        sq = [full_value(x.float().square().sum()) for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum(0))


def clip_by_global_norm(grads: Any, max_norm: float, lanes: bool = False
                        ) -> Tuple[Any, torch.Tensor]:
    gnorm = global_norm(grads, lanes)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    def clip(g):
        s = scale.reshape((-1,) + (1,) * (g.dim() - 1)) if lanes else scale
        return g.float() * s
    return tree_map(clip, grads), gnorm


def zip_map(fn, *trees):
    """``fn`` over the matching leaves of dictionary trees of one
    layout."""
    if isinstance(trees[0], dict):
        return {k: zip_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def update(cfg: OptimizerConfig, params: Any, grads: Any,
           state: AdamWState, *, lanes: bool = False
           ) -> Tuple[Any, AdamWState]:
    new_params, new_state, _, _ = _update(cfg, params, grads, state, lanes)
    return new_params, new_state


def apply_updates(cfg: OptimizerConfig, params: Any, grads: Any,
                  state: AdamWState
                  ) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    """(new params, new state, {"grad_norm": the global norm of
    ``grads`` before clipping, a 0-d float32 tensor; "lr": this step's
    learning rate})."""
    new_params, new_state, gnorm, lr = _update(cfg, params, grads, state,
                                               False)
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def _update(cfg: OptimizerConfig, params: Any, grads: Any,
            state: AdamWState, lanes: bool):
    """(params, state, the gradients' global norm before clipping, lr)."""
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, lanes)
    else:
        gnorm = global_norm(grads, lanes)
        grads = tree_map(lambda g: g.float(), grads)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
    lane_axes = 1 if lanes else 0

    def upd(p, g, m, v):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay > 0 and p.dim() - lane_axes >= 2:
            delta = delta + cfg.weight_decay * p.float()
        newp = p.float() - lr * delta
        return newp.to(p.dtype), m, v

    out = zip_map(upd, params, grads, state.mu, state.nu)
    return (tree_map(lambda o: o[0], out),
            AdamWState(step, tree_map(lambda o: o[1], out),
                       tree_map(lambda o: o[2], out)), gnorm, lr)
