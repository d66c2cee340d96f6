"""The online predicate-serving subsystem (``repro.serve``):

* ``PredicateServer``: concurrent query sessions over one resident
  ``ScaleDocEngine`` (worker pool + bounded admission queue);
* ``QuerySession``: explicit lifecycle (QUEUED -> TRAINING -> SCORING ->
  ORACLE_WAIT -> DONE), streaming accepted/rejected deltas, stats;
* ``OracleBroker``: cross-session oracle micro-batching over the
  engine's shared ``CachedOracle`` label caches;
* resilience: ``ChaosOracle`` fault injection and the
  ``ResilientOracle`` policy (retry with decorrelated-jitter backoff,
  circuit breaker, bisect-on-failure);
* ``StandingSession``: a session-shaped handle over one standing
  predicate (``PredicateServer.subscribe``), streaming a ``DeltaBatch``
  per processed commit group of a live collection until cancelled.
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
                                      SessionState, StandingSession,
                                      StandingState)

__all__ = ["BreakerConfig", "ChaosConfig", "ChaosOracle", "CircuitBreaker",
           "Delta", "OracleBroker", "OracleError", "OracleFault",
           "OracleTimeout", "OracleUnavailable", "PredicateServer",
           "QueryRequest", "QuerySession", "ResilientOracle", "RetryPolicy",
           "ServerClosed", "ServerSaturated", "SessionCancelled",
           "SessionOracleHandle", "SessionState", "StandingSession",
           "StandingState", "decorrelated_jitter"]
