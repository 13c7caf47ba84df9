"""Named wall-clock spans aggregated into a process-wide registry.

:func:`span` / :func:`span_stats` / :func:`reset_spans` are the always-on
production timers the serving scheduler (serve/scheduler.py), the commit
trace (obs/trace.py), the replica engine's catch-up path (engine.py,
codec/packed.py, ops/merge.py) and the Prometheus renderer (obs/prom.py)
share: they attribute commit latency to its stages (parse, merge,
publish) without a profiler attached.  Each span also enters
``torch.profiler.record_function(name)``, so a ``torch.profiler`` trace
taken around a serving run names the same stages beside the kernels.

While a ``torch.profiler`` session records on a thread (no other
switch), each span closed there is also kept in a bounded in-memory
ring, :func:`span_log`: name, id, parent and root (the thread's stack of
open spans), thread, start and end on the profiler's own clock, and what
:func:`count` added while it was the innermost open span.  A
:func:`phase` is such a record that ends where the next begins (the
merge's stages, through ``utils.chainaudit``'s stage markers).  With no
profiler a span pays one boolean call for it, and a count or a phase is
that call alone.

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

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

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

# The span log: while a profiler records on a thread, every span closed
# there is also kept as a record in this ring (the oldest dropped past
# RING records, and counted).
RING = 65536
_ring: collections.deque = collections.deque(maxlen=RING)
_dropped = 0
_ids = itertools.count(1)
_tls = threading.local()        # .stack: open records; .phase: open phase
# True while a torch.profiler session records on the calling thread
# (one C call); spans open ring records only then
recording = torch.autograd._profiler_enabled


@contextlib.contextmanager
def _logged(name: str):
    """The block as ``record_function(name)`` and, while a profiler
    records, as a ring record opened under the thread's innermost open
    record (its parent; the outermost is its root).  Records are stamped
    on the profiler's clock: kineto stamps its host events in nanoseconds
    of CLOCK_REALTIME (``time.time_ns``), with or without CUDA activity,
    so a record lines up with its own ``record_function`` event
    unscaled."""
    global _dropped
    with torch.profiler.record_function(name):
        if not recording():
            yield
            return
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        rid = next(_ids)
        up = stack[-1] if stack else None
        rec = {"name": name, "id": rid,
               "parent": up["id"] if up else None,
               "root": up["root"] if up else rid,
               "thread": threading.get_ident(),
               "start_ns": time.time_ns(), "end_ns": None, "counts": {}}
        stack.append(rec)
        try:
            yield
        finally:
            rec["end_ns"] = time.time_ns()
            if stack[-1] is rec:
                stack.pop()
            else:
                stack.remove(rec)
            with _spans_lock:
                if len(_ring) == _ring.maxlen:
                    _dropped += 1
                _ring.append(rec)


@contextlib.contextmanager
def span(name: str):
    """``with span("serve.merge"): ...`` — accumulate the block's wall
    time under ``name`` in the process-wide span registry (thread-safe;
    the registry lock is held only for the counter update, never across
    the timed block).  While a profiler records on this thread the span
    is also a record of the span log (:func:`span_log`), stamped inside
    its ``record_function`` event."""
    t0 = time.perf_counter()
    try:
        with _logged(name):
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


def phase(name: Optional[str]) -> None:
    """End this thread's open phase, if any, and, while a profiler
    records, begin the phase ``name`` (None: begin none): a span-log
    record inside its own ``record_function`` event that lasts until the
    thread's next call.  One phase is open a thread at a time; phases
    are not kept in the always-on registry."""
    cur = getattr(_tls, "phase", None)
    if cur is not None:
        _tls.phase = None
        cur.__exit__(None, None, None)
    if name is not None and recording():
        cur = _logged(name)
        cur.__enter__()
        _tls.phase = cur


def count(name: str, n: int = 1) -> None:
    """While a profiler records, add ``n`` to ``name`` in the counts of
    this thread's innermost open span-log record (:func:`span_log`);
    otherwise nothing."""
    if recording():
        stack = getattr(_tls, "stack", None)
        if stack:
            c = stack[-1]["counts"]
            c[name] = c.get(name, 0) + n


def span_log() -> Dict[str, Any]:
    """The span log: ``records``, oldest first, each a dict of ``name``,
    ``id``, ``parent`` (None at a root), ``root``, ``thread``,
    ``start_ns``, ``end_ns`` (the profiler's clock) and ``counts`` (what
    :func:`count` added while it was the innermost open record); and
    ``dropped``, the records the ring let go."""
    with _spans_lock:
        return {"records": list(_ring), "dropped": _dropped}


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
    """Drop accumulated spans and span-log records (names starting with
    ``prefix``; with none, the ring's dropped count too)."""
    global _dropped
    with _spans_lock:
        for name in [n for n in _spans if n.startswith(prefix)]:
            del _spans[name]
        kept = [r for r in _ring if not r["name"].startswith(prefix)]
        _ring.clear()
        _ring.extend(kept)
        if not prefix:
            _dropped = 0
