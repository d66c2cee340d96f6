"""The online predicate-serving subsystem (``repro.serve``):

* ``PredicateServer``: concurrent query sessions over one resident
  ``ScaleDocEngine`` (worker pool + bounded admission queue);
* ``QuerySession``: explicit lifecycle (QUEUED -> TRAINING -> SCORING ->
  ORACLE_WAIT -> DONE), streaming accepted/rejected deltas, stats;
* ``OracleBroker``: cross-session oracle micro-batching over the
  engine's shared ``CachedOracle`` label caches;
* resilience: ``ChaosOracle`` fault injection and the
  ``ResilientOracle`` policy (retry with decorrelated-jitter backoff,
  circuit breaker, bisect-on-failure).

Standing sessions over live collections are not ported yet (ROADMAP.md).
"""
from repro_torch.serve.broker import OracleBroker, SessionOracleHandle
from repro_torch.serve.resilience import (BreakerConfig, ChaosConfig,
                                          ChaosOracle, CircuitBreaker,
                                          OracleError, OracleFault,
                                          OracleTimeout,
                                          OracleUnavailable,
                                          ResilientOracle, RetryPolicy,
                                          decorrelated_jitter)
from repro_torch.serve.server import (Delta, PredicateServer, QueryRequest,
                                      QuerySession, ServerClosed,
                                      ServerSaturated, SessionCancelled,
                                      SessionState)

__all__ = ["BreakerConfig", "ChaosConfig", "ChaosOracle", "CircuitBreaker",
           "Delta", "OracleBroker", "OracleError", "OracleFault",
           "OracleTimeout", "OracleUnavailable", "PredicateServer",
           "QueryRequest", "QuerySession", "ResilientOracle", "RetryPolicy",
           "ServerClosed", "ServerSaturated", "SessionCancelled",
           "SessionOracleHandle", "SessionState", "decorrelated_jitter"]
