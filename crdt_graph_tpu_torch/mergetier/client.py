"""The front-end's merge-tier client: routing, worker selection,
breakers, the end-to-end budget, and the fallback ladder.

The client owns every decision between "this round is remote-eligible"
(serve/scheduler.py asks via :func:`route_min_ops`) and "here is a
verified materialized frame — or a counted reason to merge locally":

1. **encode** the document's prepared candidate set (mergetier/wire.py);
2. **pick a worker** — round-robin over the pool, skipping workers
   whose breaker is open (``fail_streak >= threshold``, the
   anti-entropy breaker shape) except for one probe per cooldown so a
   recovered worker can close its breaker again;
3. **send** — in process (the transport twin: the worker object
   itself) or over HTTP through the pooled, netchaos-aware connection
   factory, under the ``GRAFT_MERGETIER_BUDGET_S`` budget — so a
   netchaos cut/delay on the merge link exercises exactly this path;
4. **verify** — decode (frame digest recomputed), the echoed
   ``input_digest`` bound to OUR request, and the structural dry-check
   against the candidate set we hold (enough status rows, shared
   capacity at least ours, sane node count);
5. any failure at any rung raises :class:`MergeFallback` with a
   counted reason — the scheduler's answer is always the bit-identical
   local merge on the front-end's own device (the same kernels), never
   a failed write.

``GRAFT_MERGETIER=0`` (explicitly set) is the kill switch: the serving
engine refuses to arm the client at all, so every ``crdt_mergetier_*``
family disappears and the A/B baseline is the untouched local path.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..serve.metrics import Histogram, LATENCY_BOUNDS_MS
from ..utils import profiling
from ..utils.hostenv import env_float as _env_float
from ..utils.hostenv import env_int as _env_int
from . import wire
from .worker import WIDTH_BOUNDS

DEFAULT_MIN_OPS = 4096
# generous by design: the budget is a hang-breaker, not a latency SLO
# (a worker's first epoch builds the kernels), and the ladder makes an
# overrun a local merge, never a failed write
DEFAULT_BUDGET_S = 30.0
DEFAULT_BREAKER_THRESHOLD = 3
DEFAULT_BREAKER_COOLDOWN_S = 1.0

# the fallback ladder's counted rungs (prom label values — keep stable)
FALLBACK_REASONS = ("no_worker", "breaker_open", "transport", "timeout",
                    "http_status", "wire", "digest", "dry_check")


def tier_enabled() -> bool:
    """``GRAFT_MERGETIER`` truthy — the tier's master switch."""
    return os.environ.get("GRAFT_MERGETIER", "0").strip() \
        not in ("", "0")


def tier_killed() -> bool:
    """``GRAFT_MERGETIER=0`` EXPLICITLY set — the A/B kill switch,
    which overrides even an explicitly constructed client."""
    raw = os.environ.get("GRAFT_MERGETIER")
    return raw is not None and raw.strip() == "0"


def route_min_ops() -> int:
    """Single-document rounds at least this many fused ops ship
    remote (grouped rounds are always remote-eligible — coalescing
    across the fleet is the whole point)."""
    return _env_int("GRAFT_MERGETIER_MIN_OPS", DEFAULT_MIN_OPS)


class MergeFallback(Exception):
    """One counted rung of the fallback ladder: the remote merge did
    not produce a verified frame, merge locally instead."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(detail or reason)
        self.reason = reason


class _Worker:
    """One pool member: transport + breaker state."""

    __slots__ = ("endpoint", "obj", "host", "port", "fail_streak",
                 "opens", "last_attempt", "sent", "ok")

    def __init__(self, spec: Any):
        self.obj = None
        self.host = self.port = None
        if hasattr(spec, "handle_merge"):      # in-process twin
            self.obj = spec
            self.endpoint = getattr(spec, "name", "mergeworker")
        else:                                  # "host:port"
            self.endpoint = str(spec)
            host, _, port = self.endpoint.rpartition(":")
            self.host, self.port = host, int(port)
        self.fail_streak = 0
        self.opens = 0
        self.last_attempt = 0.0
        self.sent = 0
        self.ok = 0


class MergeTierClient:
    """Pooled merge workers behind one verified-or-fallback call."""

    def __init__(self, workers: Sequence[Any], src: str = "frontend",
                 budget_s: Optional[float] = None,
                 breaker_threshold: int = DEFAULT_BREAKER_THRESHOLD,
                 breaker_cooldown_s: float = DEFAULT_BREAKER_COOLDOWN_S,
                 pool=None, chaos=None):
        if not workers:
            raise ValueError("merge tier needs at least one worker")
        self.src = str(src)
        self.workers = [_Worker(w) for w in workers]
        if budget_s is None:
            budget_s = _env_float("GRAFT_MERGETIER_BUDGET_S",
                                  DEFAULT_BUDGET_S)
        self.budget_s = float(budget_s)
        self.breaker_threshold = max(1, int(breaker_threshold))
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self._chaos = chaos
        self._own_pool = pool is None
        if pool is None and any(w.obj is None for w in self.workers):
            from ..cluster import netchaos as netchaos_mod
            from ..cluster.pool import ConnectionPool
            pool = ConnectionPool(
                connect=lambda *a: netchaos_mod.connect(
                    self._chaos, *a))
        self.pool = pool
        self._mu = threading.Lock()
        self._rr = 0
        self.remote_rounds = 0
        self.remote_docs = 0
        self.remote_ops = 0
        self.fallbacks: Dict[str, int] = {}
        self.remote_ms = Histogram(LATENCY_BOUNDS_MS)
        self.width_hist = Histogram(WIDTH_BOUNDS)

    @classmethod
    def from_env(cls, src: str = "frontend",
                 kv=None) -> Optional["MergeTierClient"]:
        """Endpoints from ``GRAFT_MERGETIER_WORKERS`` (comma-separated
        ``host:port``), falling back to the cluster pool registry when
        a KV is supplied (cluster/mergepool.py).  None when the env
        arms the tier but names no reachable worker — the engine then
        stays local rather than arming a client that can only fall
        back."""
        raw = os.environ.get("GRAFT_MERGETIER_WORKERS", "").strip()
        eps = [e.strip() for e in raw.split(",") if e.strip()]
        if not eps and kv is not None:
            from ..cluster import mergepool
            eps = [w["addr"] for w in mergepool.list_workers(kv)]
        if not eps:
            return None
        return cls(eps, src=src)

    # -- worker selection --------------------------------------------------

    def _breaker_open(self, w: _Worker) -> bool:
        return w.fail_streak >= self.breaker_threshold

    def _pick(self) -> _Worker:
        """Round-robin over closed-breaker workers; when every breaker
        is open, probe the least-recently-tried one per cooldown so
        recovery is observable without unthrottled retry storms."""
        now = time.monotonic()
        with self._mu:
            n = len(self.workers)
            for i in range(n):
                w = self.workers[(self._rr + i) % n]
                if not self._breaker_open(w):
                    self._rr = (self._rr + i + 1) % n
                    w.last_attempt = now
                    return w
            probe = min(self.workers, key=lambda w: w.last_attempt)
            if now - probe.last_attempt >= self.breaker_cooldown_s:
                probe.last_attempt = now
                return probe
        raise MergeFallback("breaker_open",
                            "every merge worker's breaker is open")

    def _record(self, w: _Worker, ok: bool) -> None:
        with self._mu:
            w.sent += 1
            if ok:
                w.ok += 1
                w.fail_streak = 0
            else:
                w.fail_streak += 1
                if w.fail_streak == self.breaker_threshold:
                    w.opens += 1

    def _count_fallback(self, reason: str) -> None:
        with self._mu:
            self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1

    # -- one document ------------------------------------------------------

    def _send(self, w: _Worker, body: bytes,
              timeout: float) -> Tuple[int, bytes]:
        if w.obj is not None:
            status, resp, _ = w.obj.handle_merge(body)
            return status, resp
        resp, raw = self.pool.request(
            self.src, w.endpoint, w.host, w.port, "POST", "/merge",
            body=body, headers={"Content-Type":
                                "application/octet-stream"},
            timeout=timeout)
        return resp.status, raw

    @profiling.span("mergetier.merge_one")
    def merge_one(self, doc_id: str, p, num_new: int,
                  trace_ctx: Optional[Dict] = None):
        """One document's remote merge: encode → send → verify.
        Returns ``(table, shared_capacity, width, sub)`` — ``sub`` is
        the traced round's transport/queue/launch split (None unless
        ``trace_ctx`` rode out AND the worker echoed its timings) — or
        raises :class:`MergeFallback` with the ladder rung that broke."""
        import socket
        from http.client import HTTPException
        t0 = time.perf_counter()
        with profiling.span("mergetier.encode_request"):
            body = wire.encode_request(doc_id, p, num_new,
                                       trace_meta=trace_ctx)
            digest = wire.request_digest(p)
        try:
            w = self._pick()
        except MergeFallback as e:
            self._count_fallback(e.reason)
            raise
        try:
            status, raw = self._send(w, body, self.budget_s)
        except socket.timeout as e:
            self._record(w, False)
            self._count_fallback("timeout")
            raise MergeFallback("timeout", str(e)) from e
        except (OSError, HTTPException, RuntimeError) as e:
            # RuntimeError: the in-process twin's closed batcher —
            # the same severance a dead worker process presents
            self._record(w, False)
            self._count_fallback("transport")
            raise MergeFallback(
                "transport", f"{type(e).__name__}: {e}") from e
        if status != 200:
            self._record(w, False)
            self._count_fallback("http_status")
            raise MergeFallback("http_status",
                                f"merge worker answered {status}")
        try:
            with profiling.span("mergetier.decode_response"):
                table, meta = wire.decode_response(raw)
        except wire.MergeWireError as e:
            self._record(w, False)
            self._count_fallback("wire")
            raise MergeFallback("wire", str(e)) from e
        with profiling.span("mergetier.verify"):
            if meta.get("input_digest") != digest:
                # a response bound to some OTHER request must never be
                # committed, however well-formed its frame is
                self._record(w, False)
                self._count_fallback("digest")
                raise MergeFallback("digest",
                                    "response bound to a different request")
            shared, width = meta["shared_capacity"], meta["width"]
            import numpy as np
            if shared < p.capacity or int(np.asarray(
                    table.status).shape[0]) < p.num_ops \
                    or not (0 < int(table.num_nodes)
                            <= int(table.ts.shape[0])):
                # the dry-check: a verified-transport frame that cannot
                # structurally be THIS candidate set's materialization
                self._record(w, False)
                self._count_fallback("dry_check")
                raise MergeFallback("dry_check",
                                    "frame inconsistent with candidate set")
        self._record(w, True)
        with self._mu:
            self.remote_docs += 1
            self.remote_ops += int(num_new)
        total_ms = (time.perf_counter() - t0) * 1e3
        self.remote_ms.observe(total_ms)
        self.width_hist.observe(width)
        sub = None
        if trace_ctx is not None:
            try:
                wm = meta.get("worker_ms")
                if wm is not None:
                    wait = float(wm.get("wait", 0.0))
                    sub = {"transport": round(max(0.0, total_ms - wait),
                                              3),
                           "queue": float(wm.get("queue", 0.0)),
                           "launch": float(wm.get("launch", 0.0)),
                           "worker": str(meta.get("worker",
                                                  w.endpoint))}
            except (TypeError, ValueError, AttributeError):
                sub = None
        return table, shared, width, sub

    # -- one scheduler round -----------------------------------------------

    def merge_round(self, items: Sequence[Tuple]
                    ) -> List[Any]:
        """Fan one round's documents out concurrently (so they ride
        ONE worker linger window even from a single front-end) and
        return, per item, either ``(table, shared, width, sub)`` or
        the :class:`MergeFallback` that stopped it.  Never raises —
        every slot gets an answer the scheduler can act on.  Items are
        ``(doc_id, p, num_new)`` or ``(doc_id, p, num_new,
        trace_ctx)``."""
        with self._mu:
            self.remote_rounds += 1
        results: List[Any] = [None] * len(items)

        def one(i: int, doc_id: str, p, num_new: int,
                trace_ctx: Optional[Dict] = None) -> None:
            try:
                results[i] = self.merge_one(doc_id, p, num_new,
                                            trace_ctx=trace_ctx)
            except MergeFallback as e:
                results[i] = e

        if len(items) == 1:
            one(0, *items[0])
            return results
        threads = [threading.Thread(
            target=one, args=(i, *it), daemon=True)
            for i, it in enumerate(items)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + self.budget_s + 1.0
        for i, t in enumerate(threads):
            t.join(max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                # the slot's answer is owed NOW; if the straggler
                # lands later its frame is simply dropped
                self._count_fallback("timeout")
                results[i] = MergeFallback(
                    "timeout", "remote merge overran the round budget")
        return results

    # -- lifecycle / telemetry ---------------------------------------------

    def close(self) -> None:
        if self._own_pool and self.pool is not None:
            self.pool.close()

    def stats(self) -> Dict[str, Any]:
        with self._mu:
            out = {
                "remote_rounds": self.remote_rounds,
                "remote_docs": self.remote_docs,
                "remote_ops": self.remote_ops,
                "fallbacks": dict(self.fallbacks),
                "workers": [{
                    "endpoint": w.endpoint,
                    "inproc": w.obj is not None,
                    "sent": w.sent,
                    "ok": w.ok,
                    "fail_streak": w.fail_streak,
                    "breaker_open": self._breaker_open(w),
                    "breaker_opens": w.opens,
                } for w in self.workers],
            }
        out["remote_ms"] = self.remote_ms.export()
        out["width"] = self.width_hist.export()
        if self.pool is not None and self._own_pool:
            out["pool"] = self.pool.stats()
        return out
