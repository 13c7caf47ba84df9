"""Background anti-entropy: every node pulls every peer's applied-op
suffix on a short interval, so any write accepted anywhere reaches
every replica without a client in the loop.

This is the reference's ``operationsSince`` contract
(CRDTree.elm:390-418) run server-to-server: each (peer, doc) pair keeps
a **high-water mark** — the timestamp of the last Add served by THAT
peer — and each round pulls ``GET /docs/{d}/ops?since=<hw>&limit=<cap>``
off the peer's published snapshot (``codec.packed.packed_since_window``: the
window is bounded, always ends on an Add so the mark stays a valid
``since`` terminator, and the ``X-Since-More`` header makes a giant
catch-up resume immediately instead of waiting a round per window).
The inclusive-terminator overlap row and any write that raced in twice
absorb as duplicates — idempotence is the CRDT's, not the daemon's.

Failure shape (docs/CLUSTER.md §Failure matrix):

- **peer down** — per-peer exponential backoff with jitter
  (``base·2^k``, capped), reset on the first successful round; the
  daemon never blocks on a dead peer longer than the HTTP timeout;
- **peer persistently down / partitioned** — a per-peer CIRCUIT
  BREAKER layered over the backoff (docs/CLUSTER.md §Partitions &
  staleness): past ``breaker_threshold`` consecutive failures the
  breaker opens and full sync rounds stop against that peer; only
  bounded PROBE pulls (the ``/docs`` listing plus at most one window
  of at most one document) fire — on the capped backoff cadence, or
  immediately on a priority wake, which during an open breaker
  performs exactly one probe rather than a full unthrottled round.
  A successful probe closes the breaker and the next round resumes
  full sync.  A ``health`` EWMA (1.0 = perfect) summarizes each
  peer's recent success rate for the ``crdt_peer_health`` gauge;
- **partition staleness is wire-observable** — :meth:`AntiEntropy.
  lag_seconds` (the max seconds since ANY live peer was last fully
  synced) is stamped on every fleet read as ``X-Ae-Lag-Seconds``,
  and a read carrying a staleness bound gets 503 instead of silently
  stale data when the replica is partitioned past it
  (cluster/gateway.py ``check_staleness``);
- **peer restarted with an empty log** — the peer answers
  ``X-Since-Found: 0`` for a mark it no longer knows; the puller
  resets that mark to 0 and re-pulls from scratch (duplicates absorb)
  instead of spinning on empty batches;
- **local backpressure** — a pull that sheds on our own admission
  queue (``QueueFull``) is NOT a peer failure: the round moves on and
  the next round retries with the same mark.

Pulled deltas enter through the ordinary write path
(``ServedDoc.apply_body`` → scheduler → published snapshot), so synced
ops are observable exactly like client writes: commit records, trace
ids (``ae-<node>-<n>``), and oracle-visible snapshot publishes.

Serving-side cost of a MID-HISTORY catch-up (a rejoining node resuming
from an old mark): the peer's window resolves against its chunked
checkpoint base (oplog.py) and loads only the chunks covering the
requested rows — O(window), no longer one whole-base load per first
cold pull (docs/OPLOG.md §Chunked base).
"""
from __future__ import annotations

import hashlib
import json
import random
import threading
import time
from http.client import HTTPConnection, HTTPException
from typing import Dict, Optional

from ..codec.packed import EMPTY_BATCH_BYTES
from ..obs.trace import (AE_PEER_HEADER, SINCE_FOUND_HEADER,
                         SINCE_MORE_HEADER, SINCE_NEXT_HEADER,
                         TRACE_FRONTIER_HEADER)
from ..serve.metrics import Histogram, LATENCY_BOUNDS_MS
from ..serve.queue import QueueFull, SchedulerStopped
from . import netchaos as netchaos_mod

# health EWMA weight: score = (1-w)·score + w·outcome — ~8 recent
# outcomes dominate, so a healed peer recovers visibly within a few
# rounds and one blip doesn't tank a healthy link
_HEALTH_W = 0.2


class _PeerFailure(Exception):
    pass


class _PeerState:
    __slots__ = ("name", "addr", "hw", "hw_digest", "pulls",
                 "ops_applied", "dup_windows_skipped",
                 "dup_window_304s", "failures",
                 "fail_streak", "backoff_until", "last_ok", "last_err",
                 "known_docs", "health", "breaker_opens", "probes")

    def __init__(self, name: str, addr: str):
        self.name = name
        self.addr = addr
        # partition-aware degradation (docs/CLUSTER.md §Partitions &
        # staleness): success-rate EWMA + circuit-breaker telemetry.
        # The breaker itself is DERIVED state — open iff fail_streak
        # >= the daemon's threshold — so closing it is exactly the
        # existing first-success streak reset, never a second flag
        # that could disagree with it.
        self.health = 1.0
        self.breaker_opens = 0
        self.probes = 0
        self.hw: Dict[str, int] = {}     # doc -> last Add ts served
        # the peer's /docs listing from the last successful round —
        # how a rejoining node knows a document it doesn't hold yet
        # EXISTS somewhere (the read path's 503-instead-of-404 hint)
        self.known_docs: frozenset = frozenset()
        # doc -> (since, quoted-sha1-etag) of the last window APPLIED
        # from this peer: `operations_since` serves the terminator row
        # inclusively, so at steady state every round re-serves a
        # known-duplicate window — byte-identical to the one already
        # applied — which must not churn the scheduler forever.  The
        # fingerprint doubles as the wire validator: the next re-pull
        # of the same mark sends it as If-None-Match, and the peer's
        # window ETag (serve/snapshot.py) answers a bodyless 304 —
        # the steady-state dup skip without shipping the window at all
        self.hw_digest: Dict[str, tuple] = {}
        self.pulls = 0
        self.ops_applied = 0
        self.dup_windows_skipped = 0
        self.dup_window_304s = 0
        self.failures = 0
        self.fail_streak = 0
        self.backoff_until = 0.0
        self.last_ok: Optional[float] = None   # monotonic
        self.last_err: Optional[str] = None


class AntiEntropy(threading.Thread):
    """One node's sync daemon.  ``node`` is the
    :class:`~crdt_graph_tpu_torch.cluster.gateway.ClusterNode` that owns it
    (membership view + local engine)."""

    def __init__(self, node, interval_s: float = 0.25,
                 delta_cap: int = 65_536,
                 backoff_base_s: float = 0.25,
                 backoff_max_s: float = 10.0,
                 jitter: float = 0.25,
                 http_timeout_s: float = 15.0,
                 max_windows_per_doc: int = 10_000,
                 breaker_threshold: int = 5,
                 seed: Optional[int] = None):
        super().__init__(name=f"antientropy-{node.name}", daemon=True)
        self.node = node
        self.interval_s = interval_s
        self.delta_cap = delta_cap
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.jitter = jitter
        self.http_timeout_s = http_timeout_s
        self.max_windows_per_doc = max_windows_per_doc
        # consecutive failures before the peer's circuit breaker opens
        # (full rounds stop; only probes fire on the backoff cadence)
        self.breaker_threshold = max(1, int(breaker_threshold))
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._round_lock = threading.Lock()
        self._peers: Dict[str, _PeerState] = {}
        self._lock = threading.Lock()    # guards _peers + counters
        self.rounds = 0
        self.round_ms = Histogram(LATENCY_BOUNDS_MS)
        self._trace_n = 0
        self.local_shed = 0
        self.priority_pulls = 0
        self.probe_pulls = 0
        self._last_priority_wake = 0.0
        # the doc a priority wake asked for: an open-breaker peer's
        # probe pulls THIS doc (one window) instead of a full round
        self._priority_doc: Optional[str] = None
        self.started_at = time.monotonic()

    # -- lifecycle --------------------------------------------------------

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()

    def request_priority(self, doc: str) -> None:
        """A read just 503'd for ``doc`` (catch-up window): wake the
        daemon NOW instead of waiting out the interval, and ignore
        peer backoff for the round — the requested document is pulled
        with everything else the round covers.  Rate-limited to one
        immediate wake per second: clients polling their Retry-After
        must not turn every 503 into a back-to-back full sync round
        that hammers backing-off (possibly failing) peers."""
        now = time.monotonic()
        with self._lock:
            self.priority_pulls += 1
            self._priority_doc = doc
            if now - self._last_priority_wake < 1.0:
                return
            self._last_priority_wake = now
        self._wake.set()

    def run(self) -> None:
        while True:
            woken = self._wake.wait(self.interval_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                # a priority wake overrides per-peer backoff: the doc
                # the reader wants may live behind a backing-off peer
                self.sync_now(respect_backoff=not woken)
            except Exception:   # noqa: BLE001 — daemon boundary: a bug
                pass            # must not kill replication for good

    # -- one round --------------------------------------------------------

    def sync_now(self, respect_backoff: bool = False) -> Dict[str, bool]:
        """Run ONE full round synchronously in the calling thread (the
        deterministic entry the tier-1 chaos test drives; the daemon
        loop calls it too).  Returns per-peer success.  Serialized —
        a test-driven round and a daemon round never interleave."""
        with self._round_lock:
            t0 = time.perf_counter()
            results: Dict[str, bool] = {}
            now = time.monotonic()
            with self._lock:
                priority_doc, self._priority_doc = \
                    self._priority_doc, None
            members = self.node.members()
            for name, lease in sorted(members.items()):
                if name == self.node.name:
                    continue
                st = self._peer_state(name, lease.addr)
                tripped = st.fail_streak >= self.breaker_threshold
                if respect_backoff and now < st.backoff_until:
                    continue
                try:
                    if tripped:
                        # open circuit breaker: never a full round —
                        # one bounded probe (listing + at most one
                        # window of at most one doc), fired on the
                        # capped backoff cadence or, right now, by a
                        # priority wake (respect_backoff=False).  A
                        # success closes the breaker below; the NEXT
                        # round resumes full sync.
                        self._probe_peer(st, priority_doc)
                    else:
                        self._sync_peer(st)
                except (_PeerFailure, OSError, HTTPException,
                        ValueError, json.JSONDecodeError) as e:
                    # HTTPException: the peer died mid-response
                    # (IncompleteRead et al. are not OSErrors) — a
                    # PEER failure like any other, not a round-abort
                    self._peer_failed(st, e)
                    results[name] = False
                else:
                    with self._lock:
                        # first success fully resets the failure
                        # machinery: streak, backoff, AND (because the
                        # breaker is derived from the streak) the open
                        # circuit — pinned by the backoff-hygiene test
                        st.fail_streak = 0
                        st.backoff_until = 0.0
                        # the lag clock resets on FULL rounds only: a
                        # successful PROBE proves reachability, not
                        # sync — minutes of unpulled writes may remain
                        # behind it, and lag_seconds() feeding the
                        # bounded-staleness 503 must not report ~0
                        # until the next full round actually pulled
                        # everything
                        if not tripped:
                            st.last_ok = time.monotonic()
                        st.health = min(
                            1.0, (1 - _HEALTH_W) * st.health
                            + _HEALTH_W)
                    results[name] = True
            # fold the marks peers have pulled against US into the
            # per-doc stability watermark, then let the cascade op-log
            # advance its checkpoint base / GC cleared segments
            # (cluster/gateway.py; a failure here must never break
            # replication — GC is an optimization, the gate is safety)
            try:
                self.node.update_stability()
            except Exception:   # noqa: BLE001 — GC boundary
                pass
            with self._lock:
                self.rounds += 1
                self.round_ms.observe((time.perf_counter() - t0) * 1e3)
            return results

    def _peer_state(self, name: str, addr: str) -> _PeerState:
        with self._lock:
            st = self._peers.get(name)
            if st is None:
                st = self._peers[name] = _PeerState(name, addr)
            elif st.addr != addr:
                # the peer restarted on a new port: its log may be
                # fresh too — the marks stay (X-Since-Found resets any
                # that no longer resolve) but the transport must follow
                st.addr = addr
            return st

    def _peer_failed(self, st: _PeerState, e: Exception) -> None:
        with self._lock:
            st.failures += 1
            st.fail_streak += 1
            st.health = (1 - _HEALTH_W) * st.health
            if st.fail_streak == self.breaker_threshold:
                st.breaker_opens += 1
            st.last_err = repr(e)
            # the exponent is clamped: a peer dead for hours reaches
            # streaks where an unbounded 2**n overflows float and the
            # raise would abort the whole sync round
            delay = min(self.backoff_max_s,
                        self.backoff_base_s
                        * 2 ** min(st.fail_streak - 1, 32))
            delay *= 1.0 + self.jitter * self._rng.random()
            st.backoff_until = time.monotonic() + delay

    def breaker_open(self, name: str) -> bool:
        """Whether ``name``'s circuit breaker is currently open — the
        scrub repair path avoids fetching through a peer the daemon
        already knows is down/partitioned."""
        with self._lock:
            st = self._peers.get(name)
            return st is not None \
                and st.fail_streak >= self.breaker_threshold

    # -- the wire ---------------------------------------------------------

    def _connect(self, st: _PeerState, peer: str,
                 fresh: bool = False) -> HTTPConnection:
        """Outbound connection to a peer: LEASED from the node's
        pooled-connection pool (cluster/pool.py, threaded through the
        armed netchaos plan — chaos rides the SAME link the real
        traffic does); plain per-request netchaos.connect for embedded
        nodes without a pool."""
        host, port = st.addr.rsplit(":", 1)
        pool = getattr(self.node, "pool", None)
        if pool is None:
            return netchaos_mod.connect(
                getattr(self.node, "netchaos", None), self.node.name,
                peer, host, int(port), self.http_timeout_s)
        return pool.lease(self.node.name, peer, host, int(port),
                          self.http_timeout_s, fresh=fresh)

    def _open_round(self, st: _PeerState, peer: str):
        """Lease a connection and issue the round's FIRST request
        (``GET /docs``), absorbing at most one stale keep-alive reuse
        (a peer restarted on the same port invalidates pooled
        connections; counting that as a peer failure would back off a
        healthy peer — the same absorb ``ConnectionPool.request`` does
        for the one-shot paths).  A stale failure mid-round stays a
        genuine peer failure: the connection was just proven live.
        Returns ``(conn, status, body)`` with the response fully
        read."""
        from .pool import STALE_ERRORS
        conn = self._connect(st, peer)
        try:
            conn.request("GET", "/docs")
            resp = conn.getresponse()
            return conn, resp.status, resp.read()
        except STALE_ERRORS:
            reused = getattr(conn, "_pool_reused", False)
            self._release(conn, ok=False)
            if not reused:
                raise
        except BaseException:
            self._release(conn, ok=False)
            raise
        conn = self._connect(st, peer, fresh=True)
        try:
            conn.request("GET", "/docs")
            resp = conn.getresponse()
            return conn, resp.status, resp.read()
        except BaseException:
            self._release(conn, ok=False)
            raise

    def _release(self, conn: HTTPConnection, ok: bool) -> None:
        """A clean round returns the connection to the pool; ANY
        failure poisons it (the pool evicts it and the next round
        opens fresh — a chaos cut or a dead peer never leaves a
        wounded connection behind for a later round)."""
        pool = getattr(self.node, "pool", None)
        if pool is None:
            conn.close()
        else:
            pool.release(conn, ok=ok)

    def _sync_peer(self, st: _PeerState) -> None:
        conn, status, body = self._open_round(st, st.name)
        ok = False
        try:
            if status != 200:
                raise _PeerFailure(f"GET /docs -> {status}")
            docs = json.loads(body)["docs"]
            with self._lock:
                st.known_docs = frozenset(docs)
            for doc in docs:
                self._pull_doc(conn, st, doc)
            ok = True
        finally:
            self._release(conn, ok)

    def _probe_peer(self, st: _PeerState,
                    priority_doc: Optional[str]) -> None:
        """The open-breaker probe: refresh the peer's ``/docs``
        listing and pull AT MOST ONE window of AT MOST ONE document
        (the priority doc when the peer holds it, else the first
        listed) — never the full unthrottled round a blind priority
        wake used to run against a down peer."""
        with self._lock:
            st.probes += 1
            self.probe_pulls += 1
        conn, status, body = self._open_round(st, st.name)
        ok = False
        try:
            if status != 200:
                raise _PeerFailure(f"GET /docs -> {status}")
            docs = json.loads(body)["docs"]
            with self._lock:
                st.known_docs = frozenset(docs)
            probe = priority_doc if priority_doc in docs else \
                (docs[0] if docs else None)
            if probe is not None:
                self._pull_doc(conn, st, probe, max_windows=1)
            ok = True
        finally:
            self._release(conn, ok)

    def _pull_doc(self, conn: HTTPConnection, st: _PeerState,
                  doc: str, max_windows: Optional[int] = None) -> None:
        for _ in range(max_windows or self.max_windows_per_doc):
            since = st.hw.get(doc, 0)
            # the pull names its node: the peer folds this mark into
            # its causal-stability watermark (the gate on its op-log's
            # checkpoint advancement + segment GC — docs/OPLOG.md).
            # When the mark hasn't moved since the last applied
            # window, the stored fingerprint rides as If-None-Match:
            # a peer whose window is unchanged answers a bodyless 304
            # (marks still advance off the X-Since-* headers) — the
            # steady-state idle fleet stops shipping known-duplicate
            # windows entirely
            hdrs = {AE_PEER_HEADER: self.node.name}
            known = st.hw_digest.get(doc)
            if known is not None and known[0] == since:
                hdrs["If-None-Match"] = known[1]
            conn.request("GET", f"/docs/{doc}/ops?since={since}"
                                f"&limit={self.delta_cap}",
                         headers=hdrs)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status == 404:
                return              # raced a just-created doc listing
            if resp.status == 304:
                # unchanged window: a dup skip that never left the
                # peer's NIC — same bookkeeping as the digest skip
                with self._lock:
                    st.pulls += 1
                    st.dup_windows_skipped += 1
                    st.dup_window_304s += 1
                nxt = resp.getheader(SINCE_NEXT_HEADER)
                if nxt is not None:
                    st.hw[doc] = int(nxt)
                if resp.getheader(SINCE_MORE_HEADER) != "1":
                    return
                continue
            if resp.status != 200:
                raise _PeerFailure(f"GET /ops -> {resp.status}")
            with self._lock:
                st.pulls += 1
            if resp.getheader(SINCE_FOUND_HEADER) == "0":
                if since == 0:
                    return          # peer genuinely has nothing
                st.hw[doc] = 0      # peer lost our mark: full resync
                continue
            if body != EMPTY_BATCH_BYTES:
                etag = f'"{hashlib.sha1(body).hexdigest()}"'
                if st.hw_digest.get(doc) == (since, etag):
                    # byte-identical to the window already applied
                    # from this mark: the inclusive-terminator overlap
                    # (plus any trailing-delete tail) at steady state
                    # — nothing new, skip the write path entirely
                    with self._lock:
                        st.dup_windows_skipped += 1
                else:
                    applied = self._apply(doc, body)
                    with self._lock:
                        st.ops_applied += applied
                    st.hw_digest[doc] = (since, etag)
                    if applied and hasattr(self.node,
                                           "note_ae_window"):
                        # visible-at-replica: the window's
                        # trace frontier names the commits it carried
                        # and the peer's send timestamp — stamp
                        # ae_apply spans + the ledger's replica-stage
                        # bound on THIS (pulling) node
                        self.node.note_ae_window(
                            doc, st.name,
                            resp.getheader(TRACE_FRONTIER_HEADER))
            nxt = resp.getheader(SINCE_NEXT_HEADER)
            if nxt is not None:
                st.hw[doc] = int(nxt)
            if resp.getheader(SINCE_MORE_HEADER) != "1":
                return
        if max_windows is not None:
            return      # bounded probe: the rest waits for a full round
        raise _PeerFailure(f"doc {doc!r}: window chain exceeded "
                           f"{self.max_windows_per_doc}")

    def _apply(self, doc: str, body: bytes) -> int:
        from ..core import operation as op_mod
        self._trace_n += 1
        tid = f"ae-{self.node.name}-{self._trace_n:08d}"
        try:
            accepted, applied = self.node.engine.get(doc).apply_body(
                body, trace_id=tid)
        except QueueFull as e:
            # OUR admission queue is full — local backpressure, not a
            # peer fault.  Raised BEFORE the mark advances (the caller
            # reads X-Since-Next after apply), so the next round
            # re-pulls this same window and nothing is lost.
            with self._lock:
                self.local_shed += 1
            raise _PeerFailure(f"local admission queue full: {e}") \
                from e
        except SchedulerStopped as e:
            raise _PeerFailure(f"local engine stopped: {e}") from e
        if not accepted:
            # a window the PEER applied must apply here too (our log
            # is a superset of the pulled prefix) — a rejection is a
            # transient local condition, and silently skipping it
            # while the mark advances would lose the window for good
            raise _PeerFailure(f"local apply rejected window of "
                               f"doc {doc!r}")
        return op_mod.count(applied)

    def lag_seconds(self) -> float:
        """Replication lag upper bound: the MAX seconds since any live
        lease-table peer was last fully synced (0.0 with no peers).
        A member NEVER fully synced since daemon start is ``inf`` —
        a replica restarted after an hour of downtime cannot bound how
        stale its durable state is, and stamping a start-relative
        near-zero would be exactly the silent-stale lie the 503
        exists to prevent (prom renders the gauge as ``+Inf``; a
        bounded read refuses until the first full round lands).
        Stamped on every fleet read as ``X-Ae-Lag-Seconds`` and
        compared against the bounded-staleness read contract (gateway
        ``check_staleness``): if the fleet held writes we haven't
        pulled, they are at most this old — a partitioned replica's
        lag grows without bound until the link heals."""
        now = time.monotonic()
        # the ring's TTL-cached membership snapshot, NOT a fresh KV
        # lease scan — this runs on every fleet read (the lag stamp)
        names = self.node.live_member_names() \
            if hasattr(self.node, "live_member_names") \
            else self.node.members()
        members = set(names) - {self.node.name}
        if not members:
            return 0.0
        lag = 0.0
        with self._lock:
            for name in members:
                st = self._peers.get(name)
                if st is None or st.last_ok is None:
                    return float("inf")
                lag = max(lag, now - st.last_ok)
        return lag

    def peers_with(self, doc: str) -> list:
        """Live-peer names whose last ``/docs`` listing included
        ``doc`` — evidence the document exists somewhere even though
        this node doesn't hold it (yet)."""
        members = set(self.node.members()) - {self.node.name}
        with self._lock:
            return sorted(name for name, st in self._peers.items()
                          if name in members and doc in st.known_docs)

    # -- exposition -------------------------------------------------------

    def stats(self) -> Dict:
        """Counter/gauge snapshot (``/cluster`` + the
        ``crdt_cluster_antientropy_*`` prom families)."""
        now = time.monotonic()
        with self._lock:
            peers = {
                name: {
                    "addr": st.addr,
                    "pulls": st.pulls,
                    "ops_applied": st.ops_applied,
                    "dup_windows_skipped": st.dup_windows_skipped,
                    "dup_window_304s": st.dup_window_304s,
                    "failures": st.failures,
                    "fail_streak": st.fail_streak,
                    "backoff_s": max(0.0, round(
                        st.backoff_until - now, 3)),
                    # the LAG signal: seconds since this peer was last
                    # fully synced (daemon-start-relative until the
                    # first success)
                    "sync_age_s": round(
                        now - (st.last_ok if st.last_ok is not None
                               else self.started_at), 3),
                    "docs_tracked": len(st.hw),
                    "last_err": st.last_err,
                    # partition-aware degradation surface
                    # (docs/CLUSTER.md §Partitions & staleness)
                    "health": round(st.health, 4),
                    "breaker_open":
                        st.fail_streak >= self.breaker_threshold,
                    "breaker_opens": st.breaker_opens,
                    "probes": st.probes,
                }
                for name, st in sorted(self._peers.items())
            }
            return {
                "rounds": self.rounds,
                "interval_s": self.interval_s,
                "delta_cap": self.delta_cap,
                "round_ms": self.round_ms.snapshot(),
                "round_ms_export": self.round_ms.export(),
                "local_shed": self.local_shed,
                "priority_pulls": self.priority_pulls,
                "probe_pulls": self.probe_pulls,
                "breaker_threshold": self.breaker_threshold,
                "peers": peers,
            }
