"""The persistent predicate engine and the offline indexer
(``repro.engine``)."""
from repro_torch.core.oracle import CachedOracle, SimulatedOracle
from repro_torch.engine.engine import (FilterResult, LeafReport,
                                       ScaleDocEngine)
from repro_torch.engine.executor import ScoringExecutor, ScoringStats
from repro_torch.engine.ingest import (IngestResult, Ingestor, IngestStats,
                                       build_index, corpus_digest,
                                       ingest_fingerprint)
from repro_torch.engine.predicate import (FALSE, TRUE, UNKNOWN, Predicate,
                                          SemanticPredicate)
from repro_torch.engine.store import (DocumentStore, InMemoryStore,
                                      MemmapStore, StoreFingerprintError,
                                      StoreManifest, StoreWriter, as_store,
                                      load_manifest)

__all__ = ["CachedOracle", "DocumentStore", "FALSE", "FilterResult",
           "InMemoryStore", "IngestResult", "IngestStats", "Ingestor",
           "LeafReport", "MemmapStore", "Predicate", "ScaleDocEngine",
           "ScoringExecutor", "ScoringStats", "SemanticPredicate",
           "SimulatedOracle", "StoreFingerprintError", "StoreManifest",
           "StoreWriter", "TRUE", "UNKNOWN", "as_store", "build_index",
           "corpus_digest", "ingest_fingerprint", "load_manifest"]
