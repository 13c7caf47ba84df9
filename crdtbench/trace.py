"""The traced window: ``torch.profiler`` over the first
:data:`SECONDS` of the measured window (a fixed sub-window: the profiler
has been seen to record nothing from about a minute into a process),
with the benchmark's own spans around the program calls it drives, and
the reduction of the trace to device busy time, time by device op, and
idle gaps by what the host was doing.

Window arithmetic copied from the port's ``bench/profile.py`` (device
busy share of a window's wall time, time by kernel name), with the busy
time taken as the union of the device's spans rather than their sum, so
overlapping work is not counted twice.
"""
from __future__ import annotations

import functools
import time

import numpy as np

WINDOW = "crdtbench.window"
NO_SPAN = "host (no annotated work)"
SECONDS = 30.0      # the traced sub-window, from the window's start
QUIET_S = 5.0       # a trace whose device line ends earlier than this
                    # before the sub-window closes stopped recording


class Tracer:
    """Profiles from :meth:`start` to :meth:`stop`, which a driver calls
    at step boundaries: it starts with the window and stops after the
    first step that ends ``seconds`` into it.  ``spans`` is a list of
    (object, attribute, label): each call of that attribute while the
    profiler runs, on any thread, is timed as a span of that label."""

    def __init__(self, spans):
        self.spans = spans
        self.seconds = SECONDS
        self.labels = [label for _, _, label in spans]
        self._saved = []
        self.on = False

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.host = []            # (start, end, label) on the host clock
        for obj, attr, label in self.spans:
            orig = getattr(obj, attr)

            @functools.wraps(orig)
            def wrapped(*a, _orig=orig, _label=label, **kw):
                t0 = time.perf_counter()
                try:
                    return _orig(*a, **kw)
                finally:
                    self.host.append((t0, time.perf_counter(), _label))
            self._saved.append((obj, attr, orig, attr in vars(obj)))
            setattr(obj, attr, wrapped)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        self.t0 = time.perf_counter()
        self.on = True

    def stop(self):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        for obj, attr, orig, own in self._saved:
            if own:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)      # back to the class's method
        self._saved = []
        self.on = False

    def reduce(self) -> dict:
        """busy_s, window_s, device time by name, and idle gaps by span."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        dev, host = [], {label: [] for label in self.labels}
        win = None
        for ev in self.prof.events():
            tr = ev.time_range
            on_dev = getattr(ev, "device_type", None) == cuda
            if on_dev and (getattr(ev, "is_user_annotation", False)
                           or ev.name == WINDOW or ev.name in host):
                continue            # a span's copy on the device's line
            if on_dev:
                dev.append((tr.start, tr.end, ev.name))
            elif ev.name == WINDOW:
                win = (tr.start, tr.end)
        if win is None:
            raise RuntimeError("the trace holds no window span")
        w0, w1 = win
        # the spans were timed on the host's clock (the profiler records
        # only its own thread's): map it onto the trace's by the window
        scale = (w1 - w0) / max(self.t1 - self.t0, 1e-9)
        for a, b, label in self.host:
            host[label].append((w0 + (a - self.t0) * scale,
                                w0 + (b - self.t0) * scale))
        by_name = {}
        iv = []
        for s, e, name in dev:
            s, e = max(s, w0), min(e, w1)
            if e > s:
                by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
                iv.append((s, e))
        busy, gaps = _union_and_gaps(sorted(iv), w0, w1)
        gap_by = _attribute(gaps, host)
        last = max((e for _, e in iv), default=w0)
        return {"busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6,
                "device_ops_s": by_name,
                "idle_gaps_s": gap_by,
                "device_events": len(dev),
                "quiet_tail_s": (w1 - last) / 1e6}


def stopped_recording(profile: dict) -> bool:
    """Whether a card's trace lost its end: no device event at all, or a
    device line quiet for more than :data:`QUIET_S` before the close."""
    return not profile["device_events"] or profile["quiet_tail_s"] > QUIET_S


def _union_and_gaps(iv, w0, w1):
    busy, gaps, cur = 0.0, [], w0
    for s, e in iv:
        if s > cur:
            gaps.append((cur, s))
            cur = s
        if e > cur:
            busy += e - cur
            cur = e
    if w1 > cur:
        gaps.append((cur, w1))
    return busy, gaps


def _timeline(host: dict) -> list:
    """Disjoint (start, end, label) segments: at each instant, the
    annotated span that started last among those open (the innermost
    on one thread; the newest across threads)."""
    import heapq
    bounds = []
    for label, spans in host.items():
        for s, e in spans:
            if e > s:
                bounds.append((s, 1, e, label))
                bounds.append((e, 0, s, label))
    bounds.sort(key=lambda b: (b[0], b[1]))
    segs, heap, closed = [], [], {}
    prev = None
    for t, opening, other, label in bounds:
        while heap and closed.get((-heap[0][0], heap[0][1]), 0):
            key = (-heap[0][0], heap[0][1])
            closed[key] -= 1
            heapq.heappop(heap)
        if heap and prev is not None and t > prev:
            segs.append((prev, t, heap[0][1]))
        prev = t
        if opening:
            heapq.heappush(heap, (-t, label))
        else:
            closed[(other, label)] = closed.get((other, label), 0) + 1
    return segs


def _attribute(gaps, host: dict) -> dict:
    """Each idle gap's time to the annotated span in force
    (:func:`_timeline`), the rest of it to :data:`NO_SPAN`."""
    segs = _timeline(host)
    out, j = {}, 0
    for g0, g1 in gaps:
        covered = 0.0
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            a, b = max(segs[k][0], g0), min(segs[k][1], g1)
            if b > a:
                out[segs[k][2]] = out.get(segs[k][2], 0.0) + (b - a) / 1e6
                covered += b - a
            k += 1
        if g1 - g0 > covered:
            out[NO_SPAN] = out.get(NO_SPAN, 0.0) + (g1 - g0 - covered) / 1e6
    return out


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
