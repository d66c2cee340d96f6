"""ScaleDocPipeline — per-query compatibility shim over ScaleDocEngine
(``repro.core.pipeline``).

  pipeline = ScaleDocPipeline(embeddings, proxy_cfg, cascade_cfg)
  result = pipeline.query(e_q, oracle, accuracy_target=0.9)

The original pipeline re-ran the full online phase from scratch per
query. It is a thin wrapper over the persistent engine
(``repro_torch.engine.ScaleDocEngine``), which adds a DocumentStore, a
composable Predicate algebra and cross-query oracle/proxy caches; new
code should target the engine directly:

  engine = ScaleDocEngine(InMemoryStore(embeddings), proxy_cfg, cascade_cfg)
  res = engine.filter(SemanticPredicate(e_q1, o1) & ~SemanticPredicate(e_q2, o2),
                      accuracy_target=0.9)

A fresh shim per query is the "independent" baseline that compound
savings are stated against: nothing is shared between its queries.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.config import CascadeConfig, ProxyConfig
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


class ScaleDocPipeline:
    """Compatibility shim — NOT the primary API.

    Constructs a private ScaleDocEngine per instance (on ``device``,
    ``"cuda"`` by default) and forwards ``query``; it shares no caches
    across instances.
    """

    def __init__(self, embeds: np.ndarray, proxy_cfg: ProxyConfig,
                 cascade_cfg: CascadeConfig, *, device="cuda"):
        from repro_torch.engine import ScaleDocEngine
        self.embeds = np.asarray(embeds, np.float32)
        self._engine = ScaleDocEngine(self.embeds, proxy_cfg, cascade_cfg,
                                      device=device)
        self.proxy_cfg = self._engine.proxy_cfg
        self.cascade_cfg = cascade_cfg

    def query(self, e_q: np.ndarray, oracle, *,
              accuracy_target: Optional[float] = None,
              ground_truth: Optional[np.ndarray] = None,
              seed: int = 0) -> QueryStats:
        return self._engine.query(e_q, oracle,
                                  accuracy_target=accuracy_target,
                                  ground_truth=ground_truth, seed=seed)
