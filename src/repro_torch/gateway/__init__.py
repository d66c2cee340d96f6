"""The network gateway (``repro.gateway``): the HTTP/SSE service plane
over ``repro_torch.serve.PredicateServer``.

* ``PredicateGateway``: a stdlib ``ThreadingHTTPServer`` front end:
  wire-format predicate submission, session lifecycle and SSE delta
  streams, standing subscriptions, per-tenant admission, and the
  ``/healthz``, ``/readyz``, ``/v1/metrics``, ``/v1/traces`` and
  ``/v1/admin/sessions`` ops surface;
* ``Tenant`` / ``TenantTable``: API-key tenants with token-bucket rate
  and max-in-flight quotas (429 + ``Retry-After`` before the server's
  queue);
* ``GatewayClient``: a thin stdlib client (submit/wait/filter/topk,
  ``iter_deltas`` and ``iter_standing`` SSE streams) with typed
  ``RateLimited``, ``GatewayUnavailable`` and ``RemoteQueryFailed``
  errors.
"""
from repro_torch.gateway.admission import (PUBLIC_TENANT, Tenant,
                                           TenantState, TenantTable,
                                           TokenBucket)
from repro_torch.gateway.client import (GatewayClient, GatewayError,
                                        GatewayUnavailable, RateLimited,
                                        RemoteQueryFailed)
from repro_torch.gateway.gateway import PredicateGateway

__all__ = ["GatewayClient", "GatewayError", "GatewayUnavailable",
           "PUBLIC_TENANT", "PredicateGateway", "RateLimited",
           "RemoteQueryFailed", "Tenant", "TenantState", "TenantTable",
           "TokenBucket"]
