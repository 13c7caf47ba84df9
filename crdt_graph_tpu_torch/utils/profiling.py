"""Named wall-clock spans aggregated into a process-wide registry.

:func:`span` / :func:`span_stats` / :func:`reset_spans` are the always-on
production timers the serving scheduler (serve/scheduler.py), the commit
trace (obs/trace.py) and the Prometheus renderer (obs/prom.py) share:
they attribute commit latency to its stages (parse, merge, publish)
without a profiler attached.  Each span also enters
``torch.profiler.record_function(name)``, so a ``torch.profiler`` trace
taken around a serving run names the same stages beside the kernels.

Beside them, the reference's harness:

- :func:`timed` — wall-clock statistics of any callable, each run closed
  by a forced device→host readback of its result (``bench.honest.force``);
  returns ``(stats, result)``;
- :func:`trace` — a ``torch.profiler`` session (the CPU, and the card
  when there is one) that writes a Chrome trace into a directory;
- :func:`table_stats` — structural summary of a merged ``NodeTable``
  (fan-out, depth, tombstone load).

The reference's ``trace`` also has a kill switch (``GRAFT_NO_JAX_TRACE``)
and a bounded stop for a TPU backend whose ``stop_trace`` hangs; the
PyTorch profiler has no such hang, so neither is here.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch


def timed(fn: Callable[..., Any], *args, repeats: int = 5,
          warmup: int = 1) -> Tuple[Dict[str, float], Any]:
    """Run ``fn(*args)`` ``warmup`` times, then ``repeats`` timed times,
    each run ending in a forced readback of its result
    (``bench.honest.force``, which waits for the card); return ``(stats,
    result)``: ``p50_ms``, ``min_ms``, ``max_ms`` and ``warmup_ms`` (the
    warm-up runs together), and the last run's host copy of the result.
    For a large result return a fingerprint from ``fn``
    (``bench.honest.fingerprint``) so the copy stays out of the time."""
    from ..bench.honest import force
    out = None
    t0 = time.perf_counter()
    for _ in range(max(1, warmup)):
        out = force(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = force(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    stats = {
        "p50_ms": times[len(times) // 2] * 1e3,
        "min_ms": times[0] * 1e3,
        "max_ms": times[-1] * 1e3,
        "warmup_ms": first * 1e3,
    }
    return stats, out


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("build/trace") as prof:`` — a ``torch.profiler``
    session over the block (CPU activity, and the card's where there is
    one); on exit its Chrome trace is written into ``log_dir`` as
    ``trace_<pid>_<ms>.json`` (the path is ``prof.trace_path``)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(prof.trace_path)


def table_stats(table) -> Dict[str, Any]:
    """Structural summary of a ``NodeTable`` (tensors on any device, or
    host arrays): the reference's record, computed the same way."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else \
            np.asarray(x)
    exists = host(table.exists)
    depth = host(table.depth)[exists]
    parent = host(table.parent)[exists]
    tomb = host(table.tombstone)[exists]
    dead = host(table.dead)[exists]
    n = int(exists.sum())
    if n == 0:
        return {"nodes": 0, "visible": 0}
    fanout = np.bincount(parent)
    return {
        "nodes": n,
        "visible": int(host(table.num_visible)),
        "tombstones": int(tomb.sum()),
        "dead": int(dead.sum()),
        "max_depth": int(depth.max()),
        "mean_depth": float(depth.mean()),
        "max_fanout": int(fanout.max()),
        "tombstone_ratio": float(tomb.sum() / n),
    }

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
