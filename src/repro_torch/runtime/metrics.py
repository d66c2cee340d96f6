"""Metrics sinks (a copy of ``repro.runtime.metrics``).

* ``Metrics``: in-memory ring + optional JSONL file (training loops).
* ``CounterSet``: thread-safe counters / gauges / value observations
  for the online serving subsystem (``repro_torch.serve``): session
  latencies, admission-queue depth, oracle micro-batch occupancy.
  Exported as one JSON-serializable snapshot so a server can answer
  "how am I doing" without stopping.
* ``render_prometheus``: a snapshot in the Prometheus text format.
"""
from __future__ import annotations

import json
import math
import random
import re
import threading
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional


class Metrics:
    """In-memory ring + optional JSONL file sink.

    The file handle stays open across ``log()`` calls (append + flush
    per record); ``close()`` — or using the instance as a context
    manager — flushes and releases it. Logging after close keeps
    feeding the in-memory ring only.
    """

    def __init__(self, path: Optional[str] = None, keep: int = 10_000):
        self.path = Path(path) if path else None
        self.ring: deque = deque(maxlen=keep)
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.path.open("a")
        else:
            self._fh = None

    def log(self, step: int, **values) -> None:
        rec = {"step": step, "time": time.time(), **values}
        self.ring.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec, default=float) + "\n")
            self._fh.flush()

    def last(self) -> Optional[Dict]:
        return self.ring[-1] if self.ring else None

    @property
    def closed(self) -> bool:
        return self._fh is None

    def close(self) -> None:
        """Flush and close the JSONL sink (idempotent)."""
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "Metrics":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


RESERVOIR_SIZE = 1024


class _Observation:
    """Streaming summary of one observed value series.

    Alongside the running count/sum/min/max/last it keeps a bounded
    reservoir (Vitter's Algorithm R, fixed-seed PRNG so snapshots are
    reproducible) from which ``summary()`` reports p50/p95/p99: exact
    order statistics while ``count <= RESERVOIR_SIZE``, an unbiased
    uniform-sample estimate beyond that — O(1) memory either way, which
    is what lets a server export latency percentiles forever without
    retaining every observation.
    """

    __slots__ = ("count", "total", "min", "max", "last", "_reservoir",
                 "_rng")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.last = 0.0
        self._reservoir: List[float] = []
        self._rng = random.Random(0x5CA1ED0C)

    def add(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self.last = value
        if len(self._reservoir) < RESERVOIR_SIZE:
            self._reservoir.append(value)
        else:
            j = self._rng.randrange(self.count)
            if j < RESERVOIR_SIZE:
                self._reservoir[j] = value

    def percentiles(self, qs=(0.50, 0.95, 0.99)) -> List[float]:
        """Nearest-rank percentiles over the reservoir sample."""
        ordered = sorted(self._reservoir)
        n = len(ordered)
        if not n:
            return [0.0 for _ in qs]
        return [ordered[min(n - 1, max(0, math.ceil(q * n) - 1))]
                for q in qs]

    def summary(self) -> Dict:
        if not self.count:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "last": 0.0, "p50": 0.0, "p95": 0.0,
                    "p99": 0.0}
        p50, p95, p99 = self.percentiles()
        return {"count": self.count, "sum": self.total,
                "mean": self.total / self.count, "min": self.min,
                "max": self.max, "last": self.last,
                "p50": p50, "p95": p95, "p99": p99}


class CounterSet:
    """Thread-safe named counters, gauges and value observations.

    ``inc`` accumulates monotonically (events), ``gauge`` records the
    current level (queue depth, in-flight sessions; tracking the peak on
    the side), ``observe`` summarizes a value stream (latency seconds,
    oracle batch occupancy) as count/sum/mean/min/max/last.
    ``snapshot()`` returns one plain-dict view of everything;
    ``to_json()`` is the wire form the serving layer exports.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._peaks: Dict[str, float] = {}
        self._observations: Dict[str, _Observation] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value
            self._peaks[name] = max(self._peaks.get(name, value), value)

    def gauge_delta(self, name: str, delta: float) -> float:
        """Adjust a gauge relatively (e.g. queue depth +1/-1)."""
        with self._lock:
            value = self._gauges.get(name, 0.0) + delta
            self._gauges[name] = value
            self._peaks[name] = max(self._peaks.get(name, value), value)
            return value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            obs = self._observations.get(name)
            if obs is None:
                obs = self._observations[name] = _Observation()
            obs.add(value)

    def timer(self, name: str):
        """Context manager: observes the block's wall seconds."""
        return _Timer(self, name)

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": {k: {"value": v, "peak": self._peaks[k]}
                           for k, v in self._gauges.items()},
                "observations": {k: o.summary()
                                 for k, o in self._observations.items()},
                "time": time.time(),
            }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True,
                          default=float)


# Prometheus text exposition (format version 0.0.4). Metric names may
# only contain [a-zA-Z0-9_:] and must not start with a digit.
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str, prefix: str) -> str:
    name = _PROM_BAD.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return f"{prefix}_{name}" if prefix else name


def _prom_value(value: float) -> str:
    value = float(value)
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if math.isnan(value):
        return "NaN"
    return repr(value) if value != int(value) else str(int(value))


def render_prometheus(snapshot: Dict, prefix: str = "scaledoc") -> str:
    """Render a ``CounterSet.snapshot()`` in the Prometheus text
    exposition format (0.0.4): counters as ``counter``, gauges as
    ``gauge`` with a companion ``<name>_peak`` gauge, observations as
    ``summary`` (``<name>{quantile=...}`` p50/p95/p99 over the
    reservoir, plus exact ``_count``/``_sum`` from the running totals).
    Serve with ``Content-Type: PROMETHEUS_CONTENT_TYPE``."""
    lines: List[str] = []
    for name in sorted(snapshot.get("counters", {})):
        m = _prom_name(name, prefix)
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {_prom_value(snapshot['counters'][name])}")
    for name in sorted(snapshot.get("gauges", {})):
        g = snapshot["gauges"][name]
        m = _prom_name(name, prefix)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {_prom_value(g['value'])}")
        lines.append(f"# TYPE {m}_peak gauge")
        lines.append(f"{m}_peak {_prom_value(g['peak'])}")
    for name in sorted(snapshot.get("observations", {})):
        s = snapshot["observations"][name]
        m = _prom_name(name, prefix)
        lines.append(f"# TYPE {m} summary")
        for q in ("p50", "p95", "p99"):
            lines.append(f'{m}{{quantile="0.{q[1:]}"}} '
                         f"{_prom_value(s[q])}")
        lines.append(f"{m}_sum {_prom_value(s['sum'])}")
        lines.append(f"{m}_count {_prom_value(s['count'])}")
    return "\n".join(lines) + "\n"


class _Timer:
    def __init__(self, counters: CounterSet, name: str):
        self._counters = counters
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._counters.observe(self._name,
                               time.perf_counter() - self._t0)
        return False
