"""Delta-push fan-out: parked watchers on the publish pointer.

The read path so far is pull-shaped: every reader pays a request cycle
per *check*, even when nothing changed (the 304 made the empty check
cheap, not free).  The paper's deployment model is a push topology —
many replicas notified through a coordinating server — so this module
adds the missing tier: ``GET /docs/{id}/watch?since=`` parks the
caller on the document's publish pointer and wakes it when the NEXT
generation publishes, delivering the ops window the caller is missing.

Why this composes out of parts that already exist:

- **The wake signal is the linearization point.**  Every commit mode
  (inline, group-commit barrier, pipelined) funnels through
  ``ServedDoc.publish_prepared`` — the snapshot pointer swap — and on
  the durable paths that call happens strictly AFTER the commit's
  fsync resolved.  Notifying there means a watcher can never observe a
  generation whose fsync could still roll back.
- **The payload is the PR-15 cached window.**  A caught-up watcher
  population shares one resume mark (windows end on the same Add
  terminator for everyone), so every watcher of a generation asks for
  the SAME ``(since, limit)`` window and the per-snapshot window LRU
  serves ONE encode to all of them — the readcache hit counters are
  the proof, and the HTTP layer ships memoryviews of the one ``bytes``
  object.  A publish costs O(watchers) memoryview writes, not
  O(watchers) re-encodes.
- **Resume is exact by the window chain contract.**  ``X-Since-Next``
  marks are resumable across every tier seam (hot→cold spills,
  checkpoint advancement, GC), so a watcher that is shed — or whose
  connection dies mid-park — re-enters with its last mark and misses
  nothing: ``X-Watch-Resume-Since`` is an honest handoff, never
  silent data loss.

Contract (served by service/http.py):

- **Admission is bounded.**  Each document's registry admits at most
  ``GRAFT_WATCH_MAX`` concurrent watchers; past that the request gets
  ``429 + Retry-After`` (the same shed-at-the-door semantic as the
  write queue).
- **Long-poll mode** (default): one response per generation.  A
  request whose window already has ops answers immediately (a
  *resume* delivery); an up-to-date request parks until the next
  publish (a *notify* delivery, latency measured from the pointer
  swap) or until its park budget expires (an empty *timeout*
  heartbeat — also the bound on how long a dead connection can pin a
  registry slot).
- **SSE mode** (``mode=sse``): one streamed response, one ``ops``
  event per generation, comment heartbeats every
  ``GRAFT_WATCH_HEARTBEAT_S`` while idle (dead connections are
  detected at the next heartbeat write).  SSE never outranks the
  bounded-staleness contract: the 503 gate runs before the stream
  opens, and every event carries only what the lag stamp at open
  admitted — a long-lived stream on a partitioned replica keeps
  serving *local* generations; clients that need bounded staleness
  must re-open to re-arm the gate.
- **Slow consumers are shed, honestly.**  A watcher more than one
  window behind (``more=1`` on its delivery) gets the window PLUS
  ``X-Watch-Event: shed`` and ``X-Watch-Resume-Since`` and is handed
  back to polling ``/ops?since=`` until caught up — broadcast
  capacity is spent on caught-up watchers, and the laggard loses
  nothing because the chain is resumable.
- **Shutdown wakes everyone.**  ``ServingEngine.close`` (and a fleet
  member's crash) closes every registry; parked watchers wake and
  answer 503 instead of dangling on a dead engine.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..obs.trace import (COMMIT_SEQ_HEADER, SESSION_HEADER,
                         SINCE_FOUND_HEADER, SINCE_MORE_HEADER,
                         SINCE_NEXT_HEADER, SNAP_FP_HEADER)
from .metrics import Histogram, LATENCY_BOUNDS_MS

# per-doc concurrent-watcher cap (GRAFT_WATCH_MAX): past it the watch
# request is shed with 429 + Retry-After, exactly like the write queue
DEFAULT_WATCH_MAX = 1024

# SSE idle heartbeat cadence (GRAFT_WATCH_HEARTBEAT_S): a comment line
# per interval keeps intermediaries from timing the stream out and
# bounds how long a dead SSE connection survives undetected
DEFAULT_HEARTBEAT_S = 10.0

# long-poll park budget cap (GRAFT_WATCH_PARK_S): the server-side
# ceiling on one request's park, and therefore on how long a dead
# long-poll connection can pin a registry slot
DEFAULT_PARK_S = 30.0


def watch_fresh(meta: Dict[str, Any], since: int) -> bool:
    """Whether a window carries something a client parked at ``since``
    lacks.  ``count > 0`` alone cannot decide it: the chain contract
    RE-SERVES the inclusive Add terminator, so a fully caught-up mark
    still gets a non-empty window (``next_since == since``).  Fresh
    means: unknown mark (reset), a trimmed window (shed), or adds
    beyond the terminator (``next_since`` moved).

    Shared by the handler thread (service/http.py; resume deliveries)
    and the reactor (serve/reactor.py; notify deliveries) so the two
    cannot drift on the one predicate that decides what goes on the
    wire."""
    return (not meta["found"] or bool(meta["more"])
            or (meta["count"] > 0 and meta["next_since"] != since))


def delivery_headers(store, snap, meta: Dict[str, Any], since: int,
                     session_id: str) -> Dict[str, str]:
    """The ordered header dict of one watch window delivery: snapshot
    identity, session echo, fleet replica/lag stamps (re-sampled at
    delivery time — a park can outlive the admission-time sample),
    the ``X-Since-*`` resume state, and the window ``ETag``.

    ONE builder for both delivery tiers (handler thread and reactor),
    so their headers agree by construction.
    ``session_id`` must already be ensured (adopted or minted)."""
    out = {
        SNAP_FP_HEADER: snap.fingerprint(),
        COMMIT_SEQ_HEADER: str(snap.seq),
        SESSION_HEADER: session_id,
    }
    if hasattr(store, "extra_read_headers"):
        out.update(store.extra_read_headers(snap, ae_lag_hdr=None))
    if hasattr(store, "note_watch_delivery"):
        # visibility ledger: the FIRST delivery of this
        # generation is the delivered-to-watchers edge.  One stamp
        # site because this is the one builder both delivery tiers
        # share; the ledger dedups repeats, and a stamp failure must
        # never cost a delivery.
        try:
            store.note_watch_delivery(snap.doc_id, snap.seq)
        except Exception:   # noqa: BLE001
            pass
    out[SINCE_FOUND_HEADER] = "1" if meta["found"] else "0"
    out[SINCE_MORE_HEADER] = "1" if meta["more"] else "0"
    if meta["next_since"] is not None:
        out[SINCE_NEXT_HEADER] = str(meta["next_since"])
    out["ETag"] = meta["etag"]
    return out


class WatchFull(Exception):
    """Watch admission shed: the document's registry is at capacity
    (HTTP 429 + Retry-After)."""

    def __init__(self, doc_id: str, n: int, retry_after_s: int = 1):
        super().__init__(
            f"watch registry for {doc_id!r} is at capacity ({n} "
            f"watchers); retry or fall back to polling")
        self.retry_after_s = retry_after_s


class WatchClosed(Exception):
    """The registry was closed (engine shutdown / fleet crash) — the
    watcher answers 503 instead of dangling."""


class WatchStats:
    """One document's watch telemetry, shared by every request that
    watches it.  Thread-safe (handler threads count; the publisher
    thread never touches it — notify latency is observed by the WOKEN
    watcher, where the delivery actually happened)."""

    __slots__ = ("_mu", "admitted", "rejected", "notifies", "resumes",
                 "heartbeats", "shed_slow", "reaped", "notify_ms")

    def __init__(self):
        self._mu = threading.Lock()
        self.admitted = 0       # watch requests admitted past the cap
        self.rejected = 0       # 429s at the registry door
        self.notifies = 0       # deliveries to a PARKED watcher
        self.resumes = 0        # immediate deliveries (data was waiting)
        self.heartbeats = 0     # empty timeout responses / SSE keepalives
        self.shed_slow = 0      # slow-consumer sheds (More=1 handoffs)
        self.reaped = 0         # dead connections found at write time
        self.notify_ms = Histogram(LATENCY_BOUNDS_MS)

    def add(self, field: str, n: int = 1) -> None:
        with self._mu:
            setattr(self, field, getattr(self, field) + n)

    def observe_notify(self, ms: float) -> None:
        with self._mu:
            self.notifies += 1
            self.notify_ms.observe(ms)

    def snapshot(self) -> Dict[str, Any]:
        with self._mu:
            return {"admitted": self.admitted,
                    "rejected": self.rejected,
                    "notifies": self.notifies,
                    "resumes": self.resumes,
                    "heartbeats": self.heartbeats,
                    "shed_slow": self.shed_slow,
                    "reaped": self.reaped,
                    "notify_ms": self.notify_ms.snapshot()}


class WatchRegistry:
    """One document's parked-watcher registry: a bounded admission
    count plus the published generation the reactor delivers against
    (and an in-process waiter, the fleet canary, parks on).

    The publisher (:meth:`notify`, called from
    ``ServedDoc.publish_prepared`` right after the pointer swap) does
    O(1) work plus one command per reactor loop — it never encodes,
    never iterates watchers, never blocks on a slow consumer.  The
    reactor re-reads the published snapshot itself on wake; the
    registry only carries the wake signal and the publish timestamp
    the notify-latency histogram measures against.
    """

    def __init__(self, doc_id: str, max_watchers: int = DEFAULT_WATCH_MAX,
                 park_s: float = DEFAULT_PARK_S,
                 heartbeat_s: float = DEFAULT_HEARTBEAT_S,
                 stats: Optional[WatchStats] = None):
        self.doc_id = doc_id
        self.max_watchers = max(1, int(max_watchers))
        self.park_s = float(park_s)
        self.heartbeat_s = float(heartbeat_s)
        self.stats = stats if stats is not None else WatchStats()
        self._mu = threading.Condition()
        self._registered = 0    # admitted watcher slots currently held
        self._parked = 0        # in-process waiters inside wait_beyond
        self._reactor_parked = 0   # slots parked on the reactor
        self._seq = 0           # latest published generation
        self._published_at = 0.0   # perf_counter of that publish
        self._closed = False
        # the engine's reactor (serve/reactor.py), set by ServedDoc:
        # parked long-poll/SSE connections detach from their handler
        # threads onto it, and notify/close fan out to them there
        self.reactor = None

    # -- publisher side (any committing thread) ---------------------------

    def notify(self, seq: int) -> None:
        """A new generation published: record it and wake every
        reactor-parked watcher.  Monotone by the single-publisher contract; a stale
        call (pipelined seq gaps resolve out of order only on shed
        commits, which never publish) is ignored."""
        now = time.perf_counter()
        with self._mu:
            if seq > self._seq:
                self._seq = seq
                self._published_at = now
            self._mu.notify_all()
        r = self.reactor
        if r is not None:
            # outside the condition: the reactor enqueues a command +
            # one wakeup-pipe byte per loop — O(loops), never O(watchers)
            r.notify(self, seq, now)

    def close(self) -> None:
        """Engine shutdown / fleet crash: refuse new watchers and give
        every parked one the closed verdict, so none dangles on a dead
        engine."""
        with self._mu:
            self._closed = True
            self._mu.notify_all()
        r = self.reactor
        if r is not None:
            # reactor-parked watchers get the same named close (503 /
            # event: closed) written by the loop that owns their socket
            r.close_registry(self)

    # -- watcher side (handler threads) -----------------------------------

    def register(self) -> None:
        """Claim one watcher slot or shed at the door."""
        with self._mu:
            if self._closed:
                raise WatchClosed(f"document {self.doc_id!r} is "
                                  f"shutting down")
            if self._registered >= self.max_watchers:
                self.stats.add("rejected")
                raise WatchFull(self.doc_id, self._registered)
            self._registered += 1
            self.stats.add("admitted")

    def unregister(self) -> None:
        with self._mu:
            self._registered -= 1

    def note_reactor_park(self, n: int) -> None:
        """Reactor bookkeeping: ``+1`` when a detached connection's
        park begins on a reactor loop, ``-1`` when its delivery /
        heartbeat / reap / close releases the slot.  Keeps
        :meth:`counts` honest — tests and the prom gauge read it as
        'watchers parked'."""
        with self._mu:
            self._reactor_parked += n

    def wait_beyond(self, seq: int, timeout: float):
        """Park the calling thread until a generation PAST ``seq``
        publishes.  Returns ``("new", published_at)`` on a wake,
        ``("timeout", None)`` when the budget expires first,
        ``("closed", None)`` on shutdown.  ``published_at`` is the
        ``perf_counter`` stamp of the pointer swap."""
        deadline = time.monotonic() + max(0.0, timeout)
        with self._mu:
            self._parked += 1
            try:
                while not self._closed and self._seq <= seq:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return "timeout", None
                    self._mu.wait(remaining)
                if self._closed:
                    return "closed", None
                return "new", self._published_at
            finally:
                self._parked -= 1

    def published_state(self):
        """``(seq, published_at, closed)`` — the reactor re-checks
        this when it picks a park command up, closing the missed-wake
        window between the handler's freshness check and the loop's
        selector registration."""
        with self._mu:
            return self._seq, self._published_at, self._closed

    def counts(self) -> Dict[str, int]:
        with self._mu:
            return {"registered": self._registered,
                    "parked": self._parked + self._reactor_parked,
                    "reactor_parked": self._reactor_parked,
                    "max": self.max_watchers}

    def snapshot(self) -> Dict[str, Any]:
        out = dict(self.counts())
        out.update(self.stats.snapshot())
        return out


def merge_notify_hists(exports: List[Dict]) -> Dict[str, Any]:
    """Merge per-doc ``Histogram.export()`` dicts (shared bounds) into
    one summary with bucket-derived percentiles — the loadgen report
    and the fan-out headline aggregate notify latency across documents
    without averaging percentiles (which would be wrong)."""
    live = [e for e in exports if e and e.get("count")]
    if not live:
        return {"count": 0, "sum": 0.0, "p50": None, "p99": None,
                "max": None}
    bounds = live[0]["bounds"]
    counts = [0] * (len(bounds) + 1)
    total, s, mx = 0, 0.0, 0.0
    for e in live:
        for i, c in enumerate(e["counts"]):
            counts[i] += c
        total += e["count"]
        s += e["sum"]
        mx = max(mx, e["max"])

    def pct(q: float):
        target = q * total
        acc = 0
        for i, c in enumerate(counts):
            acc += c
            if acc >= target:
                # upper bucket bound as the conservative estimate;
                # the overflow bucket reports the observed max
                return bounds[i] if i < len(bounds) else mx
        return mx

    return {"count": total, "sum": round(s, 3), "p50": pct(0.5),
            "p99": pct(0.99), "max": mx}
