"""Per-tenant admission control for the network gateway (a copy of
``repro.gateway.admission``).

The ``PredicateServer`` already sheds load globally (bounded admission
queue -> ``ServerSaturated``); what it cannot do is keep one noisy
tenant from eating the whole queue. This module enforces *per-tenant*
limits **before** a request ever reaches the server:

  * **authentication** — API-key tenants from a config file (or passed
    inline); unknown keys are 401 before any work happens;
  * **rate** — a token bucket per tenant (``rate`` requests/second
    refill, ``burst`` capacity): exceeding it is 429 + ``Retry-After``
    computed from the refill rate, and costs the server nothing;
  * **concurrency** — ``max_in_flight`` live sessions per tenant, so a
    tenant streaming slow oracle queries cannot monopolize the worker
    pool.

All rejections are tenant-local: they consume no admission-queue slot
and never touch another tenant's sessions — the isolation property
``tests/test_torch_gateway.py`` pins.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.runtime.metrics import CounterSet

# a gateway constructed without tenants runs open: one implicit tenant,
# no API key required — the single-user / notebook configuration
PUBLIC_TENANT = "public"
_UNLIMITED = 1e9


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One tenant's identity + quota configuration."""
    name: str
    api_key: str
    rate: float = 20.0           # sustained submits/second (token refill)
    burst: float = 20.0          # bucket capacity (instantaneous spike)
    max_in_flight: int = 8       # live sessions at once
    admin: bool = False          # may list every tenant's sessions

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant needs a name")
        if self.rate <= 0 or self.burst < 1:
            raise ValueError(f"tenant {self.name!r}: rate must be > 0 "
                             "and burst >= 1")
        if self.max_in_flight < 1:
            raise ValueError(f"tenant {self.name!r}: max_in_flight "
                             "must be >= 1")


class TokenBucket:
    """Thread-safe token bucket on a monotonic clock.

    ``try_acquire`` never blocks: it either takes a token or returns the
    seconds until one will be available (the 429 ``Retry-After`` hint).
    """

    def __init__(self, rate: float, burst: float, clock=time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._stamp = clock()
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> Tuple[bool, float]:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._stamp)
                               * self.rate)
            self._stamp = now
            if self._tokens >= n:
                self._tokens -= n
                return True, 0.0
            return False, (n - self._tokens) / self.rate

    @property
    def tokens(self) -> float:
        with self._lock:
            now = self._clock()
            return min(self.burst, self._tokens + (now - self._stamp)
                       * self.rate)


class TenantState:
    """Runtime admission state for one tenant: its bucket plus the live
    sessions currently charged against ``max_in_flight``."""

    def __init__(self, tenant: Tenant, clock=time.monotonic):
        self.tenant = tenant
        self.bucket = TokenBucket(tenant.rate, tenant.burst, clock)
        self._live: List = []        # QuerySession handles
        self._reserved = 0           # slots held between admit and track
        self._lock = threading.Lock()

    def in_flight(self) -> int:
        """Live (queued or running) sessions plus admitted-but-not-yet-
        tracked reservations, pruning finished sessions — a finished
        session frees its concurrency slot lazily, on the next admission
        check, so no completion callback is needed."""
        with self._lock:
            self._live = [s for s in self._live if not s.done()]
            return len(self._live) + self._reserved

    def track(self, session) -> None:
        """Convert the slot ``admit()`` reserved into a live session."""
        with self._lock:
            if self._reserved:
                self._reserved -= 1
            self._live.append(session)

    def release(self) -> None:
        """Give back a slot reserved by ``admit()`` when the submission
        fails before a session exists (malformed body, saturation)."""
        with self._lock:
            if self._reserved:
                self._reserved -= 1

    def admit(self) -> Tuple[bool, float, str]:
        """(admitted, retry_after_seconds, reason). The concurrency slot
        is *reserved* under the lock before the bucket is consulted, so
        N racing submits cannot all pass the max_in_flight check — the
        caller must follow up with ``track()`` (success) or ``release()``
        (failure). Order matters: the rate check spends a token only if
        the concurrency check passed, so a tenant pinned at
        max_in_flight is not also drained of tokens."""
        with self._lock:
            self._live = [s for s in self._live if not s.done()]
            if len(self._live) + self._reserved >= self.tenant.max_in_flight:
                return False, 1.0, "max_in_flight"
            self._reserved += 1
        ok, retry_after = self.bucket.try_acquire()
        if not ok:
            self.release()
            return False, retry_after, "rate"
        return True, 0.0, ""

    def snapshot(self) -> Dict:
        return {"name": self.tenant.name,
                "in_flight": self.in_flight(),
                "max_in_flight": self.tenant.max_in_flight,
                "rate": self.tenant.rate,
                "burst": self.tenant.burst,
                "tokens": round(self.bucket.tokens, 3)}


class TenantTable:
    """API-key -> tenant resolution + per-tenant admission state.

    Built from ``Tenant`` records or a JSON config file
    (``{"tenants": [{"name": ..., "api_key": ..., "rate": ...,
    "burst": ..., "max_in_flight": ...}, ...]}``). An *empty* table
    runs open admission: every request maps to one implicit ``public``
    tenant with effectively unlimited quota and no key check.
    """

    def __init__(self, tenants: Optional[Iterable[Tenant]] = None,
                 clock=time.monotonic):
        tenants = list(tenants or [])
        self.open = not tenants
        if self.open:
            tenants = [Tenant(PUBLIC_TENANT, api_key="",
                              rate=_UNLIMITED, burst=_UNLIMITED,
                              max_in_flight=int(_UNLIMITED))]
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        keys = [t.api_key for t in tenants]
        if len(set(keys)) != len(keys):
            raise ValueError("duplicate API keys across tenants")
        self._by_key = {t.api_key: TenantState(t, clock) for t in tenants}
        self._by_name = {t.name: self._by_key[t.api_key] for t in tenants}

    @classmethod
    def from_file(cls, path, clock=time.monotonic) -> "TenantTable":
        blob = json.loads(Path(path).read_text())
        records = blob.get("tenants", blob if isinstance(blob, list)
                           else None)
        if not isinstance(records, list):
            raise ValueError(f"{path}: expected a 'tenants' list")
        return cls([Tenant(**rec) for rec in records], clock)

    def authenticate(self, api_key: Optional[str]) -> Optional[TenantState]:
        if self.open:
            return self._by_name[PUBLIC_TENANT]
        if not api_key:
            return None
        return self._by_key.get(api_key)

    def get(self, name: str) -> Optional[TenantState]:
        return self._by_name.get(name)

    def states(self) -> List[TenantState]:
        return list(self._by_name.values())

    def snapshot(self) -> List[Dict]:
        return [s.snapshot() for s in self.states()]

    def fold_counters(self, counters: CounterSet, name: str,
                      event: str) -> None:
        """Per-tenant accounting in the shared ``CounterSet`` — the same
        snapshot the server's metrics export, so ``/v1/metrics`` is one
        document."""
        counters.inc(f"tenant.{name}.{event}")
