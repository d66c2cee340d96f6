"""The persistent predicate engine and the offline indexer
(``repro.engine``): the predicate algebra (``SemanticPredicate`` composed
with ``&``, ``|``, ``~``, and the wire codec), ``ScaleDocEngine`` with
cross-query caches, cost-ordered compound plans, ``SemanticTopK``
execution and the degraded modes (``RepairTicket``), the cross-session
``QueryOptimizer``, the scoring executor, stores and ingest."""
from repro_torch.core.oracle import CachedOracle, SimulatedOracle
from repro_torch.engine.engine import (FilterResult, LeafReport,
                                       RepairTicket, ScaleDocEngine)
from repro_torch.engine.executor import ScoringExecutor, ScoringStats
from repro_torch.engine.ingest import (IngestResult, Ingestor, IngestStats,
                                       build_index, corpus_digest,
                                       ingest_fingerprint)
from repro_torch.engine.optimizer import (LeafArtifact, QueryOptimizer,
                                          SelectivityStats)
from repro_torch.engine.predicate import (FALSE, TRUE, UNKNOWN, And, Not,
                                          Or, Predicate, SemanticPredicate,
                                          SemanticTopK, WireFormatError,
                                          from_wire)
from repro_torch.engine.store import (DocumentStore, InMemoryStore,
                                      MemmapStore, StoreFingerprintError,
                                      StoreManifest, StoreWriter, as_store,
                                      load_manifest)

__all__ = ["And", "CachedOracle", "DocumentStore", "FALSE", "FilterResult",
           "InMemoryStore", "IngestResult", "IngestStats", "Ingestor",
           "LeafArtifact", "LeafReport", "MemmapStore", "Not", "Or",
           "Predicate", "QueryOptimizer", "RepairTicket", "ScaleDocEngine",
           "ScoringExecutor", "ScoringStats", "SelectivityStats",
           "SemanticPredicate", "SemanticTopK", "SimulatedOracle",
           "StoreFingerprintError", "StoreManifest", "StoreWriter", "TRUE",
           "UNKNOWN", "WireFormatError", "as_store", "build_index",
           "corpus_digest", "from_wire", "ingest_fingerprint",
           "load_manifest"]
