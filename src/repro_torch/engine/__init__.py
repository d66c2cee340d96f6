"""The persistent predicate engine (``repro.engine``)."""
from repro_torch.core.oracle import CachedOracle, SimulatedOracle
from repro_torch.engine.engine import (FilterResult, LeafReport,
                                       ScaleDocEngine)
from repro_torch.engine.executor import ScoringExecutor, ScoringStats
from repro_torch.engine.predicate import (FALSE, TRUE, UNKNOWN, Predicate,
                                          SemanticPredicate)
from repro_torch.engine.store import (DocumentStore, InMemoryStore,
                                      MemmapStore, as_store)

__all__ = ["CachedOracle", "DocumentStore", "FALSE", "FilterResult",
           "InMemoryStore", "LeafReport", "MemmapStore", "Predicate",
           "ScaleDocEngine", "ScoringExecutor", "ScoringStats",
           "SemanticPredicate", "SimulatedOracle", "TRUE", "UNKNOWN",
           "as_store"]
