"""Metrics registry: counters, gauges, histograms, snapshots.

A tiny in-process metrics layer sized for the engine's needs: per-run
counters (strata executed, deltas emitted, bytes rehashed, recovery
events), gauges (journal depth, live count), and histograms (per-stratum
wall time, refresh latency).  No external dependency, no background
thread — instruments update under a lock, :meth:`MetricsRegistry.snapshot`
returns a plain JSON-serializable dict that ``obs/export.py`` dumps
standalone.

A process-wide default registry (:func:`default_registry`) serves code
paths that have no natural place to thread a registry through; tests reset
it between runs (:func:`reset_default_registry`).
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional


class Counter:
    """Monotonically-increasing value (events, bytes, deltas)."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        self.value += amount

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Point-in-time value (journal depth, live delta count)."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


# Default histogram buckets: wall-clock seconds from 100µs to ~100s in
# half-decade steps — wide enough for a stratum on any backend.
_DEFAULT_BUCKETS = tuple(10.0 ** (e / 2) for e in range(-8, 5))


class Histogram:
    """Fixed-bucket histogram with running sum/count/min/max.

    Buckets are upper bounds (le); one overflow bucket catches the rest.
    """

    def __init__(self, name: str, buckets: Optional[tuple] = None):
        self.name = name
        self.buckets = tuple(sorted(buckets or _DEFAULT_BUCKETS))
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        value = float(value)
        lo, hi = 0, len(self.buckets)
        while lo < hi:                       # first bucket with le >= value
            mid = (lo + hi) // 2
            if self.buckets[mid] < value:
                lo = mid + 1
            else:
                hi = mid
        self.counts[lo] += 1
        self.total += value
        self.count += 1
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        out = {"type": "histogram", "count": self.count,
               "sum": self.total, "mean": self.mean}
        if self.count:
            out["min"] = self.min
            out["max"] = self.max
            out["buckets"] = {
                ("+inf" if i == len(self.buckets)
                 else f"{self.buckets[i]:g}"): c
                for i, c in enumerate(self.counts) if c}
        return out


class MetricsRegistry:
    """Named instruments with get-or-create semantics and one snapshot API.

    ``registry.counter("engine.strata").inc()`` — instruments are created
    on first use; asking for an existing name with a different kind
    raises (a counter silently read as a gauge is a bug, not a feature).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, **kw)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(inst).__name__}, "
                    f"not a {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[tuple] = None) -> Histogram:
        return self._get(name, Histogram, buckets=buckets)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._instruments)

    def __len__(self) -> int:
        return len(self._instruments)

    def snapshot(self) -> dict:
        """JSON-serializable {name: instrument snapshot} (sorted)."""
        with self._lock:
            return {name: inst.snapshot()
                    for name, inst in sorted(self._instruments.items())}

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """Process-wide registry."""
    return _DEFAULT


def reset_default_registry() -> None:
    _DEFAULT.reset()
