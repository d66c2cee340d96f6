"""Plain PyTorch version of the fused scoring kernel."""
from __future__ import annotations

import torch

from repro_torch.core.encoder import gelu, l2_normalize


def _latents(docs, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    h = gelu(docs.float() @ w1.float() + b1)
    h = gelu(h @ w2.float() + b2)
    return l2_normalize(h @ w3.float() + b3)


def ref_scores(docs, w1, b1, w2, b2, w3, b3, zq_normalized) -> torch.Tensor:
    """docs (N, D), zq_normalized (L,) unit -> (N,) scores in [0, 1]."""
    return 0.5 * (1.0 + _latents(docs, w1, b1, w2, b2, w3, b3)
                  @ zq_normalized)


def ref_scores_multi(docs, w1, b1, w2, b2, w3, b3, zq_stack) -> torch.Tensor:
    """Multi-query version: zq_stack (Q, L) unit rows -> (N, Q) scores."""
    return 0.5 * (1.0 + _latents(docs, w1, b1, w2, b2, w3, b3)
                  @ zq_stack.T)
