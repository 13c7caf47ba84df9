"""Named wall-clock spans aggregated into a process-wide registry.

:func:`span` / :func:`span_stats` / :func:`reset_spans` are the always-on
production timers the serving scheduler (serve/scheduler.py), the commit
trace (obs/trace.py) and the Prometheus renderer (obs/prom.py) share:
they attribute commit latency to its stages (parse, merge, publish)
without a profiler attached.  Each span also enters
``torch.profiler.record_function(name)``, so a ``torch.profiler`` trace
taken around a serving run names the same stages beside the kernels.

The reference package's ``trace()`` (a JAX profiler session) and
``table_stats`` have no counterpart here yet.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

import torch

_spans: Dict[str, Dict[str, float]] = {}
_spans_lock = threading.Lock()


@contextlib.contextmanager
def span(name: str):
    """``with span("serve.merge"): ...`` — accumulate the block's wall
    time under ``name`` in the process-wide span registry (thread-safe;
    the registry lock is held only for the counter update, never across
    the timed block)."""
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        ms = (time.perf_counter() - t0) * 1e3
        with _spans_lock:
            s = _spans.get(name)
            if s is None:
                s = _spans[name] = {"count": 0, "total_ms": 0.0,
                                    "max_ms": 0.0}
            s["count"] += 1
            s["total_ms"] += ms
            s["max_ms"] = max(s["max_ms"], ms)


def span_stats(prefix: str = "") -> Dict[str, Dict[str, float]]:
    """Snapshot of the span registry (names starting with ``prefix``),
    with per-span mean derived from count/total."""
    with _spans_lock:
        out = {}
        for name, s in _spans.items():
            if name.startswith(prefix):
                row = dict(s)
                row["mean_ms"] = s["total_ms"] / max(s["count"], 1)
                out[name] = row
        return out


def reset_spans(prefix: str = "") -> None:
    """Drop accumulated spans (names starting with ``prefix``)."""
    with _spans_lock:
        for name in [n for n in _spans if n.startswith(prefix)]:
            del _spans[name]
