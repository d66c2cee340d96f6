"""The oracle plane's resilience layer (``repro.serve.resilience``):
``ChaosOracle`` fault injection and the ``ResilientOracle`` policy
(retry with decorrelated-jitter backoff, circuit breaker,
bisect-on-failure). The rest of the JAX package's serving planes
(server, broker, gateway) is not ported yet."""
from repro_torch.serve.resilience import (BreakerConfig, ChaosConfig,
                                          ChaosOracle, CircuitBreaker,
                                          OracleError, OracleFault,
                                          OracleTimeout,
                                          OracleUnavailable,
                                          ResilientOracle, RetryPolicy,
                                          decorrelated_jitter)

__all__ = ["BreakerConfig", "ChaosConfig", "ChaosOracle", "CircuitBreaker",
           "OracleError", "OracleFault", "OracleTimeout",
           "OracleUnavailable", "ResilientOracle", "RetryPolicy",
           "decorrelated_jitter"]
