"""The persistent predicate engine and the offline indexer
(``repro.engine``): the predicate algebra (``SemanticPredicate`` composed
with ``&``, ``|``, ``~``, and the wire codec), ``ScaleDocEngine`` with
cross-query caches, cost-ordered compound plans, ``SemanticTopK``
execution and the degraded modes (``RepairTicket``), the cross-session
``QueryOptimizer``, the scoring executor, the cascade-strategy
registry, stores and ingest, and the live plane (``LiveEngine``,
``StandingPredicate``: continuous queries over an open store,
delta-only scoring per commit group)."""
from repro_torch.core.oracle import CachedOracle, SimulatedOracle
from repro_torch.engine.engine import (FilterResult, LeafReport,
                                       RepairTicket, ScaleDocEngine)
from repro_torch.engine.executor import ScoringExecutor, ScoringStats
from repro_torch.engine.ingest import (IngestResult, Ingestor, IngestStats,
                                       build_index, corpus_digest,
                                       ingest_fingerprint)
from repro_torch.engine.live import (DeltaBatch, DriftConfig, LiveEngine,
                                     LiveEngineClosed, RangeView,
                                     StandingCancelled, StandingPredicate,
                                     Subscription, standing_filter)
from repro_torch.engine.optimizer import (LeafArtifact, QueryOptimizer,
                                          SelectivityStats)
from repro_torch.engine.predicate import (FALSE, TRUE, UNKNOWN, And, Not,
                                          Or, Predicate, SemanticPredicate,
                                          SemanticTopK, WireFormatError,
                                          from_wire)
from repro_torch.engine.registry import (available_strategies,
                                         get_calibrator, get_strategy,
                                         register_calibrator,
                                         register_strategy)
from repro_torch.engine.store import (DocumentStore, InMemoryStore,
                                      MemmapStore, StoreFingerprintError,
                                      StoreManifest, StoreWriter, as_store,
                                      load_manifest)

__all__ = ["And", "CachedOracle", "DeltaBatch", "DocumentStore",
           "DriftConfig", "FALSE", "FilterResult", "InMemoryStore",
           "IngestResult", "IngestStats", "Ingestor", "LeafArtifact",
           "LeafReport", "LiveEngine", "LiveEngineClosed", "MemmapStore",
           "Not", "Or", "Predicate", "QueryOptimizer", "RangeView",
           "RepairTicket", "ScaleDocEngine", "ScoringExecutor",
           "ScoringStats", "SelectivityStats", "SemanticPredicate",
           "SemanticTopK", "SimulatedOracle", "StandingCancelled",
           "StandingPredicate", "StoreFingerprintError", "StoreManifest",
           "StoreWriter", "Subscription", "TRUE", "UNKNOWN",
           "WireFormatError", "as_store", "available_strategies",
           "build_index", "corpus_digest", "from_wire", "get_calibrator",
           "get_strategy", "ingest_fingerprint", "load_manifest",
           "register_calibrator", "register_strategy", "standing_filter"]
