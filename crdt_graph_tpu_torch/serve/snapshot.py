"""Snapshot-isolated reads: the immutable published view of a document.

The engine's node tables are persistent values, so snapshot isolation is
a pointer swap: on every merge commit the scheduler derives a
:class:`DocSnapshot` — a pinned op-log view, vector clock, visible value
sequence — and publishes it with one attribute store (atomic under the
GIL).  Readers (``GET /docs/{id}``, ``/ops?since=``, ``/clock``,
``/snapshot``) resolve entirely against the snapshot they loaded: they
never take the merge lock, never touch the live tree, and never observe
a half-committed merge.  A reader that loaded snapshot ``seq=k`` keeps a
consistent view even while ``k+1`` is being derived — that is the whole
consistency story, and it is the strongest one a pull-based CRDT service
needs: every snapshot is a real replica state (a prefix of the applied
log), and successive snapshots are monotonically ordered by ``seq``
(single-writer scheduler).

Since the cascade op-log (oplog.py), what a snapshot pins is a
**reference-stable** :class:`~crdt_graph_tpu_torch.oplog.LogView` rather than
one monolithic column set: the tiered log may spill hot ops to disk,
advance its checkpoint base, or GC cold segments while this snapshot is
being served, and none of that can shift, re-serve, or lose a window an
anti-entropy chain is mid-way through — the view keeps serving the
exact rows (and files) it captured at publish time.  Deriving a
snapshot is O(segments) descriptor capture; full-column reassembly
(``/snapshot`` bootstraps, unbounded ``/ops?since=``) happens lazily
and is cached per snapshot generation.

Derivation cost sits on the COMMIT path (the scheduler pre-warms the
visible-value sequence before publishing), so the first read after a
million-op merge is as cheap as any other read — the coalescer amortizes
the per-commit derivation across every delta fused into that commit.

Encoded-body cache: the same immutability makes the WIRE
bytes cacheable — a published generation can never change under a
cached body, so the snapshot lazily encodes-and-caches the bodies it
serves: the ``{"values": ...}`` JSON of ``GET /docs/{id}``, the
``{"replicas": ...}`` clock wire, and a bounded LRU of recent
``ops_since_window`` wire bytes keyed by ``(since, limit)`` (the
unbounded ``ops_since_bytes`` bootstrap path stays uncached — one-shot
consumers, and an O(full log) body must not pin on a live snapshot).  Every reader of generation ``seq=k`` then gets
the SAME ``bytes`` object and the HTTP layer ships a memoryview — the
read path is O(what changed) per publish, not O(doc) per request.
The conditional-GET ``ETag`` is the quoted
replica-independent :meth:`DocSnapshot.state_fingerprint`.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import engine as engine_mod
from ..oplog import LogView

# default bounded window-LRU entries per published snapshot (the
# anti-entropy steady state re-pulls the same (since, limit) window of
# an idle doc every round; catch-up chains stream distinct windows and
# evict behind themselves)
DEFAULT_WINDOW_LRU = 8


class ReadCacheStats:
    """One document's read-cache telemetry + policy: shared by every
    snapshot generation the document publishes (the cache itself is
    per-snapshot — invalidation IS the pointer swap).  Thread-safe;
    rendered as the ``crdt_readcache_*`` prom families and stamped
    into the loadgen report."""

    __slots__ = ("window_cap", "_mu", "hits", "misses",
                 "encoded_bytes", "window_evictions", "not_modified")

    def __init__(self, window_cap: int = DEFAULT_WINDOW_LRU):
        self.window_cap = max(1, int(window_cap))
        self._mu = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.encoded_bytes = 0
        self.window_evictions = 0
        self.not_modified = 0      # 304s served off the ETag contract

    def hit(self) -> None:
        with self._mu:
            self.hits += 1

    def miss(self, nbytes: int) -> None:
        with self._mu:
            self.misses += 1
            self.encoded_bytes += int(nbytes)

    def evicted(self) -> None:
        with self._mu:
            self.window_evictions += 1

    def served_304(self) -> None:
        with self._mu:
            self.not_modified += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._mu:
            return {"enabled": True,
                    "window_cap": self.window_cap,
                    "hits": self.hits, "misses": self.misses,
                    "encoded_bytes": self.encoded_bytes,
                    "window_evictions": self.window_evictions,
                    "not_modified": self.not_modified}


class DocSnapshot:
    """One immutable published read view.  All fields are frozen at
    construction; the pinned log view is reference-stable by the
    cascade contract (oplog.LogView)."""

    __slots__ = ("doc_id", "seq", "view", "values", "clock", "replica",
                 "timestamp", "cursor", "max_depth", "log_length",
                 "log_segments", "committed_at", "_fp", "_sfp",
                 "_stats", "_values_body", "_clock_body", "_etag",
                 "_win_mu", "_win", "_win_inflight", "_shm",
                 "shm_seg_name")

    def __init__(self, doc_id: str, seq: int, view: LogView,
                 values: Tuple[Any, ...], clock: Dict[int, int],
                 replica: int, timestamp: int, cursor: Tuple[int, ...],
                 max_depth: int,
                 stats: Optional[ReadCacheStats] = None,
                 shm=None):
        self.doc_id = doc_id
        self.seq = seq
        self.view = view
        self.values = values
        self.clock = clock
        self.replica = replica
        self.timestamp = timestamp
        self.cursor = cursor
        self.max_depth = max_depth
        # the LOGICAL op extent: checkpoint base + cold + hot tail —
        # identical across replicas (and tier layouts) holding the same
        # op set, because nothing is ever dropped logically
        self.log_length = view.length
        self.log_segments = view.num_segments
        self.committed_at = time.time()
        self._fp: Optional[str] = None
        self._sfp: Optional[str] = None
        # encoded-body cache (module docstring): filled lazily by the
        # first reader of each wire shape; one stats object per
        # DOCUMENT outlives the per-generation caches
        self._stats = stats if stats is not None else ReadCacheStats()
        self._values_body: Optional[bytes] = None
        self._clock_body: Optional[bytes] = None
        self._etag: Optional[str] = None
        self._win_mu = threading.Lock()
        # (kind, since, limit) -> cached wire result, LRU-ordered
        self._win: "collections.OrderedDict" = collections.OrderedDict()
        # single-flight latches: key -> Event the compute leader sets
        # (a watch notify wakes every parked watcher AT ONCE, and they
        # all ask for the same window — without the latch the whole
        # population would stampede-encode the body it is supposed to
        # share)
        self._win_inflight: Dict[Tuple, threading.Event] = {}
        # host-shared encoded-body tier (serve/shmcache.py): when
        # armed, the two whole-doc bodies below resolve against ONE
        # shared segment per generation across every process on the
        # host; ``shm_seg_name`` is this generation's claim, released
        # by the publish swap that retires it
        self._shm = shm
        self.shm_seg_name: Optional[str] = None

    # -- read endpoints ---------------------------------------------------

    @property
    def packed(self):
        """The full column set, reassembled lazily from the pinned
        view and cached per snapshot generation (cold tiers load
        through the log's LRU).  Only the full-log consumers
        (``/snapshot`` bootstrap, unbounded ``/ops?since=``) pay it —
        windowed serving touches just the window's segments."""
        return self.view.to_packed()

    def visible_values(self) -> List[Any]:
        """The Python-list accessor — for IN-PROCESS callers (the
        oracle, bench harnesses, embedded engines).  The HTTP layer
        serves :meth:`values_body` instead: one O(doc) list copy +
        ``json.dumps`` per request was the read path's dominant cost
        at scale."""
        return list(self.values)

    def clock_wire(self) -> Dict[str, int]:
        """The vector clock in wire shape (``GET /clock``)."""
        return {str(r): ts for r, ts in self.clock.items()}

    # -- encoded-body cache ------------------------------------

    @property
    def cache_stats(self) -> ReadCacheStats:
        return self._stats

    def _encode_bodies(self) -> Tuple[bytes, bytes]:
        """Both whole-doc wire bodies, straight off the encoders —
        the single source of truth every cache tier stores verbatim
        (byte-identity across the private and shared tiers is by
        construction)."""
        return (json.dumps({"values": self.values}).encode(),
                json.dumps({"replicas": self.clock_wire()}).encode())

    def _shm_fill(self) -> bool:
        """Resolve both whole-doc bodies against the host-shared tier
        (one segment per generation, serve/shmcache.py).  False means
        tier off or degraded — the caller stays on the process-local
        path."""
        shm = self._shm
        if shm is None:
            return False
        got = shm.get_or_publish(self.doc_id, self.state_fingerprint(),
                                 self._encode_bodies)
        if got is None:
            return False
        self._values_body, self._clock_body, self.shm_seg_name = got
        return True

    def values_body(self) -> bytes:
        """The exact ``GET /docs/{id}`` wire body, encoded at most once
        per published generation (lock-free: a racing first pair of
        readers may both encode — same bytes, last store wins).  With
        the shared tier armed, encoded at most once per HOST — the
        body is then a memoryview over the shared segment."""
        body = self._values_body
        if body is not None:
            self._stats.hit()
            return body
        if self._shm_fill():
            body = self._values_body
            self._stats.miss(len(body))
            return body
        body = json.dumps({"values": self.values}).encode()
        self._stats.miss(len(body))
        self._values_body = body
        return body

    def clock_body(self) -> bytes:
        """The ``GET /docs/{id}/clock`` wire body, cached like
        :meth:`values_body`."""
        body = self._clock_body
        if body is not None:
            self._stats.hit()
            return body
        if self._shm_fill():
            body = self._clock_body
            self._stats.miss(len(body))
            return body
        body = json.dumps({"replicas": self.clock_wire()}).encode()
        self._stats.miss(len(body))
        self._clock_body = body
        return body

    def etag(self) -> str:
        """The conditional-GET entity tag: the QUOTED replica-
        independent state fingerprint, so converged replicas hand out
        interchangeable validators and a new commit (which changes the
        clock/extent/values) always changes it."""
        if self._etag is None:
            self._etag = f'"{self.state_fingerprint()}"'
        return self._etag

    def _window_cached(self, key: Tuple, compute):
        """Bounded LRU over recent window wire results, SINGLE-FLIGHT
        per key.  The compute runs OUTSIDE the lock (a cold window may
        load cold segments); concurrent misses on one key elect a
        leader and the rest wait on its latch — a watch notify wakes a
        whole watcher population at once, and one encode must serve
        all of them (the fan-out contract the readcache counters
        pin)."""
        while True:
            leader, ev = False, None
            with self._win_mu:
                hit = self._win.get(key)
                if hit is not None:
                    self._win.move_to_end(key)
                else:
                    ev = self._win_inflight.get(key)
                    if ev is None:
                        ev = threading.Event()
                        self._win_inflight[key] = ev
                        leader = True
            if hit is not None:
                self._stats.hit()
                return hit
            if not leader:
                # the leader inserts then sets the latch; on its
                # failure (or an immediate eviction) the loop re-runs
                # the election instead of dangling
                ev.wait(60)
                continue
            try:
                out = compute()
            except BaseException:
                with self._win_mu:
                    self._win_inflight.pop(key, None)
                ev.set()
                raise
            body = out[0] if isinstance(out, tuple) else out
            self._stats.miss(len(body))
            with self._win_mu:
                self._win[key] = out
                self._win.move_to_end(key)
                while len(self._win) > self._stats.window_cap:
                    self._win.popitem(last=False)
                    self._stats.evicted()
                self._win_inflight.pop(key, None)
            ev.set()
            return out

    def age_s(self) -> float:
        return time.time() - self.committed_at

    def fingerprint(self) -> str:
        """Short content fingerprint of the published state (doc id,
        seq, log length, server clock): the flight recorder stamps it
        on every commit record so two records that claim the same
        result can be compared across a dump without shipping the
        columns.  Cached — derived once per snapshot."""
        if self._fp is None:
            import hashlib
            h = hashlib.sha1()
            h.update(repr((self.doc_id, self.seq, self.log_length,
                           self.timestamp,
                           sorted(self.clock.items()))).encode())
            self._fp = h.hexdigest()[:16]
        return self._fp

    def state_fingerprint(self) -> str:
        """Replica-INDEPENDENT content fingerprint (``X-State-
        Fingerprint``, cluster/gateway.py).  :meth:`fingerprint`
        identifies one server's published generation (it hashes the
        local ``seq``, which counts that server's commits), so two
        fleet replicas of the same document never agree on it even
        when fully converged.  This one hashes only what the CRDT
        itself determines — the vector clock, the LOGICAL applied-op
        extent (checkpoint base + tail, ``view.length`` — NOT the
        physical tier layout, which legitimately differs between a
        replica that has spilled/compacted and one that hasn't), and
        the materialized visible sequence — so converged replicas
        agree on it regardless of how many commits each took to get
        there or how their logs are tiered on disk.  The fleet
        convergence oracle and the chaos tests compare THIS across
        servers.  Cached; the O(visible) hash is paid at most once per
        published snapshot."""
        if self._sfp is None:
            import hashlib
            h = hashlib.sha1()
            h.update(repr((self.doc_id, sorted(self.clock.items()),
                           self.log_length, self.values)).encode())
            self._sfp = h.hexdigest()[:16]
        return self._sfp

    def ops_since_window(self, since: int, limit: int = 0):
        """Bounded resumable anti-entropy window off the pinned view:
        ``(wire_bytes, {"found", "more", "next_since", "count"})`` —
        byte-identical to ``engine.packed_since_window`` over the
        untiered full packing, at every tier seam (oplog.LogView
        window contract).  Served through the per-snapshot window LRU:
        the steady-state pull (every peer re-asking the same
        ``(since, limit)`` of an idle doc every round) stops re-slicing
        and re-encoding the window per request.

        The meta dict additionally carries ``"etag"`` — the quoted
        sha1 of the window's wire bytes, cached WITH the window (one
        hash per encode, not per request): ``GET /ops`` serves it as
        the window's ``ETag`` so a steady-state anti-entropy re-pull
        of an unchanged window is a bodyless 304 on the wire, and the anti-entropy client's
        dup-window digest compares against the same fingerprint."""

        def compute():
            import hashlib
            body, meta = self.view.window(since, limit)
            meta = dict(meta)
            meta["etag"] = f'"{hashlib.sha1(body).hexdigest()}"'
            return body, meta

        return self._window_cached(("w", since, limit), compute)

    def pinned_window(self, since: int, limit: int = 0):
        """:meth:`ops_since_window` plus an explicit buffer-lifetime
        pin: ``(body, meta, pin)`` where holding ``pin`` (this
        snapshot) for the life of an in-flight write guarantees the
        body bytes cannot be torn by a publish swap — the window LRU,
        the encode, and (for shm-backed whole-doc bodies) the segment
        claim all live on the snapshot, and the shmcache zombie-park
        contract (serve/shmcache.py) keeps exported views mapped even
        across a swap + unlink.  The reactor (serve/reactor.py) pins
        every queued delivery until its last byte drains; partial
        writes that straddle a generation swap complete from the
        pinned buffer."""
        body, meta = self.ops_since_window(since, limit)
        return body, meta, self

    def ops_since_bytes(self, since: int) -> bytes:
        """Wire JSON for ``GET /ops?since=`` off the pinned view — the
        SAME egress bytes the live tree serves
        (``engine.packed_since_bytes``): the view's descriptors and
        indexes are immutable, so any number of readers can serve
        pulls concurrently while a merge (or a spill) is in flight.
        Deliberately NOT cached: the unbounded path is the one-shot
        bootstrap (near-zero hit rate), and storing it would pin
        O(full log) wire bytes on a live snapshot the entry-count LRU
        cannot bound.  Counted as a miss — it IS egress work paid."""
        body = self.view.since_bytes(since)
        self._stats.miss(len(body))
        return body

    def checkpoint_bytes(self, compress: bool = False) -> bytes:
        """The binary packed-checkpoint bytes (``GET /snapshot``), built
        from the snapshot's own fields via the shared npz writer — the
        one-transfer bootstrap for big documents.  Uncompressed by
        default (the serving trade: zlib at 1M ops costs seconds —
        scripts/bench_egress.py — and nothing holds a lock here either
        way).  The meta carries an EMPTY ``last_op_span``: a
        bootstrapping client adopts its own identity and has no use for
        the server's last locally-applied batch."""
        import io
        p = self.packed
        meta = {
            "replica": self.replica,
            "timestamp": self.timestamp,
            "cursor": list(self.cursor),
            "replicas": {str(k): v for k, v in self.clock.items()},
            "max_depth": self.max_depth,
            "num_ops": p.num_ops,
            "hints_vouched": p.hints_vouched,
            "last_op_span": [self.log_length, self.log_length],
            "last_op_bare": False,
        }
        buf = io.BytesIO()
        engine_mod.write_packed_npz(buf, p, meta, compress=compress)
        return buf.getvalue()

    def __repr__(self) -> str:
        return (f"DocSnapshot({self.doc_id!r}, seq={self.seq}, "
                f"ops={self.log_length}, visible={len(self.values)})")


def derive(doc_id: str, seq: int, tree: "engine_mod.TpuTree",
           stats: Optional[ReadCacheStats] = None,
           shm=None) -> DocSnapshot:
    """Build the next snapshot from a just-committed tree.  Called by
    the scheduler thread (the tree's only writer) BEFORE resolving the
    merged requests, so a client's follow-up read always sees its own
    write.  ``visible_values`` is the pre-warm: it forces the host
    mirror once here so no reader ever pays the first-read
    materialization.  The log view capture is O(segments) — deriving a
    snapshot no longer re-packs the whole history on host-path commits,
    and never holds more of the log resident than the cascade already
    does."""
    return DocSnapshot(
        doc_id=doc_id, seq=seq,
        view=tree.log_view(),
        values=tuple(tree.visible_values()),
        clock=dict(tree._replicas),
        replica=tree.replica_id,
        timestamp=tree.timestamp,
        cursor=tuple(tree.cursor),
        max_depth=tree._max_depth,
        stats=stats,
        shm=shm,
    )
