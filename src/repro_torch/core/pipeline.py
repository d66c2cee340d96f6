"""``QueryStats``: what ``ScaleDocEngine.query()`` returns
(``repro.core.pipeline``'s record; the per-query shim is not ported)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.cascade import CascadeResult


@dataclasses.dataclass
class QueryStats:
    cascade: CascadeResult
    oracle_calls_total: int
    oracle_calls_train: int
    proxy_flops: float
    oracle_flops: float
    total_flops: float
    wall_seconds: float
    scores: np.ndarray
    # degraded-mode accounting; the port runs degrade="fail" only, so
    # these keep their defaults
    degraded: bool = False
    degrade_mode: Optional[str] = None
    unresolved_docs: int = 0
    fallback_docs: int = 0
    est_accuracy_debit: float = 0.0
