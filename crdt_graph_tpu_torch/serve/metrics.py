"""Serving observability: latency histograms and counters.

A copy of the reference package's ``serve.metrics`` (framework-free), so
the WAL's fsync histogram and the op log's segment-load histogram keep
the reference's bucket bounds and export shape.  The rest of the
reference's ``serve`` package is not part of this package yet.

Histograms use fixed log-scale bucket bounds so a million observations
cost O(buckets) memory and the quantile read is a cumulative scan — the
standard serving-metrics trade (exact max is tracked separately, since
the tail bucket truncates it).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

# default bounds (ms for latencies, pure counts for widths): log-ish
# spacing from sub-millisecond to tens of seconds
LATENCY_BOUNDS_MS = (0.5, 1, 2, 5, 10, 20, 50, 100, 200, 500,
                     1000, 2000, 5000, 10000, 30000)
WIDTH_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


class Histogram:
    """Fixed-bucket histogram with approximate quantiles and exact
    count/sum/max.  Thread-safe: the scheduler thread observes, HTTP
    handler threads read snapshots."""

    def __init__(self, bounds: Sequence[float] = LATENCY_BOUNDS_MS):
        self._bounds: List[float] = list(bounds)
        self._counts = [0] * (len(self._bounds) + 1)   # +1: overflow
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        k = 0
        for b in self._bounds:
            if value <= b:
                break
            k += 1
        with self._lock:
            self._counts[k] += 1
            self._count += 1
            self._sum += value
            if value > self._max:
                self._max = value

    def _quantile_locked(self, q: float) -> Optional[float]:
        if self._count == 0:
            return None
        target = q * self._count
        seen = 0
        for k, c in enumerate(self._counts):
            seen += c
            if seen >= target:
                # upper bound of the bucket the quantile falls in; the
                # overflow bucket reports the exact max instead
                return self._bounds[k] if k < len(self._bounds) \
                    else self._max
        return self._max

    def snapshot(self) -> Dict[str, float]:
        """``{count, sum, mean, p50, p99, max}`` — quantiles are bucket
        upper bounds (None fields are omitted for an empty histogram)."""
        with self._lock:
            if self._count == 0:
                return {"count": 0}
            return {
                "count": self._count,
                "sum": round(self._sum, 3),
                "mean": round(self._sum / self._count, 3),
                "p50": self._quantile_locked(0.5),
                "p99": self._quantile_locked(0.99),
                "max": round(self._max, 3),
            }

    def export(self) -> Dict[str, object]:
        """Full-fidelity exposition: the bucket BOUNDS and per-bucket
        counts (last entry = overflow past the top bound), plus exact
        count/sum/max — what ``/metrics/prom`` renders as the
        cumulative ``le`` series (obs/prom.py) and ``/debug/flight``
        embeds, instead of the quantile summary that loses the
        distribution."""
        with self._lock:
            return {
                "bounds": list(self._bounds),
                "counts": list(self._counts),
                "count": self._count,
                "sum": round(self._sum, 3),
                "max": round(self._max, 3),
            }


class Counters:
    """A named bag of monotonically increasing integers (thread-safe)."""

    def __init__(self):
        self._vals: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._vals[name] = self._vals.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._vals.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._vals)
