"""The serving engine: documents, snapshot publication, write admission.

``ServingEngine`` is a drop-in for ``service.store.DocumentStore`` (same
duck-typed surface the HTTP handlers consume) with the concurrency model
inverted, the same shape as a continuous-batching inference server:

- **Reads never lock.**  Every read endpoint resolves against the
  document's published :class:`~crdt_graph_tpu_torch.serve.snapshot.DocSnapshot`
  — an immutable value swapped in by the scheduler on commit.  A read
  issued mid-merge sees the previous snapshot, complete and consistent.
- **Writes queue.**  ``POST /ops`` bodies are parsed in the handler
  thread (native column parse for bootstrap-size pushes), admitted into
  the document's bounded queue (or refused with 429 + Retry-After), and
  merged by the single scheduler thread, which fuses every delta pending
  on a document into one merge and batches independent documents
  through one batched merge over a document axis
  (parallel.mesh.batched_materialize).
- **One thread launches on the card.**  All kernel work funnels through
  the scheduler thread; handler threads never launch, and read only
  host mirrors and published snapshots.  The engine's ``device`` is the
  card unless the caller passes another (``device="cpu"`` runs the
  kernels' plain twins); without a card and without ``device=`` it
  raises.  With a merge-tier client (``mergetier=``), the scheduler
  ships grouped runs and giant singles to a merge worker instead, and
  merges a document here only when its remote merge fails.

Consistency: coalesced deltas adopt the engine's large-batch SET
semantics across (and within) deltas — any causally valid arrival order
converges, duplicates absorb per-op, and a delta that genuinely fails
(causality gap / invalid path) is re-tried sequentially so ONLY the
guilty request gets the 409; innocent co-batched requests still commit.
A write's ticket resolves only after its commit's snapshot is published,
so every client reads its own writes.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import engine as engine_mod
from .. import wal as wal_mod
from ..codec import json_codec
from ..codec import packed as packed_mod
from ..core import operation as op_mod
from ..core.operation import Batch, Operation
from ..obs import flight as flight_mod
from ..obs import oracle as oracle_mod
from ..obs import trace as trace_mod
from ..ops import merge as merge_mod
from .. import oplog as oplog_mod
from ..oplog import PackedBatch
from . import snapshot as snapshot_mod
from . import watch as watch_mod
from .metrics import Counters, Histogram, LATENCY_BOUNDS_MS, WIDTH_BOUNDS
from .queue import DocQueue, QueueFull, SchedulerStopped, WriteTicket

SERVER_REPLICA = 0   # the server's own replica id; clients get 1, 2, …
# (canonical: service.store re-imports it — both write paths must mint
# the same identity scheme)

# applied-ops echo cap, in leaves: at or under this the response carries
# the applied ops; above it, the count only (re-encoding a bootstrap
# push into its own response costs multiples of the merge itself).
# Single source of truth — service/http.py imports it.
ECHO_LIMIT = 4096

# wire bodies at or above this many BYTES take the native column parse
# (canonical; service.store.Document.WIRE_FAST_BYTES re-imports it so
# the legacy and serving ingest routes share one crossover)
WIRE_FAST_BYTES = 1 << 20

# default kernel-launch chunk: a giant push merges as bounded row chunks
# so no single launch (or jit bucket) is sized by the largest client
DEFAULT_CHUNK_OPS = 1 << 17

# cascade op-log defaults (oplog.py; docs/OPLOG.md): served documents
# tier their logs by default so long-lived docs and sustained write
# traffic keep O(hot window) resident log bytes.  GRAFT_OPLOG_HOT_OPS=0
# disables tiering entirely.
DEFAULT_OPLOG_HOT_OPS = 32768

from ..utils.hostenv import env_float as _env_float  # noqa: E402
from ..utils.hostenv import env_int as _env_int  # noqa: E402 — the
# canonical int/float env parsers (shared with obs/flight.py's knobs)


def _env_on(name: str, default: str) -> bool:
    """Whether switch ``name`` is on: set (or defaulted) to anything
    but ``"0"`` or the empty string, the reference's rule."""
    return os.environ.get(name, default).strip() not in ("", "0")


# switches whose non-default path the port does not take from the
# environment, with the default each keeps: the reference's A/B
# baselines (the per-request re-encode, the buffered cold egress, the
# thread-per-watcher park, the serialized scheduler).  Each of them is
# an engine argument instead: ``readcache=False``, ``sendfile=False``,
# ``reactor=False`` and ``pipeline=False``.
_UNPORTED_SWITCHES = (("GRAFT_READCACHE", True), ("GRAFT_SENDFILE", True),
                      ("GRAFT_REACTOR", True), ("GRAFT_PIPELINE", True))


class ServedDoc:
    """One served document: engine tree (scheduler-owned), write queue,
    published snapshot, counters.  Read methods are Document-compatible
    and resolve purely against the published snapshot."""

    def __init__(self, doc_id: str, engine: "ServingEngine",
                 max_depth: int):
        self.doc_id = doc_id
        self._engine = engine
        # crash durability (wal.py; docs/DURABILITY.md): with a
        # durable_dir the document's tiers live in a persistent per-doc
        # subdir, every tier-layout change rewrites the manifest, and a
        # WAL under the cascade makes acked hot-tail ops survive a
        # kill; wal/epoch stay None/0 on the default ephemeral path
        self.wal: Optional[wal_mod.Wal] = None
        self.epoch = 0
        self.recovered = False
        self.replay_stats: Optional[Dict] = None
        # deferred WAL truncation: spills/folds note the new tiered
        # extent here, and the prefix is dropped only at the next
        # successful fsync (wal_mark_durable) — truncating at spill
        # time could drop records covering rows an in-flight commit's
        # WAL-shed rollback may reload out of a straddling segment
        self._wal_truncate_pending = False
        # pre-commit state for the WAL shed rollback (scheduler
        # thread only; one commit per doc per round)
        self._commit_saved: Optional[tuple] = None
        # pipelined commit path (serve/workers.py):
        # _safe_extent = the log extent no failed group fsync can roll
        # back (fsync-durable, or fully-resolved for wal-off docs) —
        # the ONLY rows the background maintenance worker may spill;
        # _round_records buffers the current round's encoded WAL
        # records (scheduler thread only); _matz_due marks a
        # cadence-due artifact refresh for the scheduler's pickup
        self._safe_extent = 0
        self._matz_due = False
        self._round_records: list = []
        # entries of THIS doc in flight on the WAL-sync worker
        # (guarded by the worker's condition) — the per-doc pipeline
        # barrier: a doc's next record appends only after its
        # previous fsync resolved; other docs flow freely
        self._sync_inflight = 0
        # seq assigned at snapshot DERIVE time (prepare_publish): the
        # published seq trails it by the in-flight pipeline window
        self._prepared_seq = 0
        if engine.durable_dir is not None:
            self._init_durable(engine, max_depth)
        else:
            self.tree = engine_mod.init(SERVER_REPLICA,
                                        max_depth=max_depth,
                                        device=engine.device)
            if engine.oplog_hot_ops > 0:
                # cascade tiering (oplog.py): hot tail in memory,
                # sealed cold segments on scratch disk, watermark-gated
                # GC.  A fleet node (cluster/gateway.py) turns
                # auto-stability off and feeds explicit anti-entropy
                # watermarks instead.
                # The subdir is PREFIXED: the wire route's doc-id
                # charset ([A-Za-z0-9_.-]) admits "." and ".." verbatim,
                # which as bare path components would alias (or escape)
                # the engine-owned spill root; "doc-.." is just a
                # filename.
                self.tree.enable_log_tiering(
                    os.path.join(engine.oplog_dir, f"doc-{doc_id}"),
                    hot_ops=engine.oplog_hot_ops,
                    hot_bytes=_env_int("GRAFT_OPLOG_HOT_BYTES", 0),
                    gc_min_segs=_env_int("GRAFT_OPLOG_GC_SEGS", 4),
                    auto_stable=not engine.external_stability,
                    ephemeral=True, cache=engine.oplog_cache)
        self.queue = DocQueue(max_requests=engine.max_queue_requests,
                              max_leaves=engine.max_queue_leaves)
        # encoded-body read cache (serve/snapshot.py): one
        # stats/policy object per document, shared by every snapshot
        # generation — invalidation is the publish pointer swap itself
        self.readcache = snapshot_mod.ReadCacheStats(
            enabled=engine.readcache_enabled,
            window_cap=engine.readcache_windows)
        # delta-push fan-out (serve/watch.py; docs/SERVING.md §Watch &
        # fan-out): bounded parked-watcher registry, woken by the
        # publish pointer swap below (publish_prepared)
        self.watch = watch_mod.WatchRegistry(
            doc_id, max_watchers=engine.watch_max,
            park_s=engine.watch_park_s,
            heartbeat_s=engine.watch_heartbeat_s)
        # reactor-backed park mode (serve/reactor.py): notify/close
        # fan out to the detached selector-parked connections
        self.watch.reactor = engine.reactor
        # scrub-with-peer-repair (docs/DURABILITY.md §Scrub & repair):
        # the maintenance lane's cadence sweep re-verifies cold-file
        # checksums and heals quarantined ranges from fleet peers
        self.scrub_stats: Dict[str, int] = {
            "runs": 0, "checked": 0, "corrupt": 0, "repaired": 0,
            "repair_failed": 0, "matz_dropped": 0,
            # WAL-stream sweep (same cadence): record framing + crc32
            # walked end to end; torn tail ≠ mid-log damage
            "wal_records": 0, "wal_torn_tail": 0, "wal_mid_log": 0}
        self._last_scrub = time.monotonic()
        self.next_replica = 1
        self._replica_lock = threading.Lock()
        # CRDT counters (parity with service.store.Document)
        self.ops_merged = 0
        self.dup_absorbed = 0
        self.batches_rejected = 0
        # scheduler observability
        self.admission_rejected = 0
        self.commit_ms = Histogram(LATENCY_BOUNDS_MS)
        self.coalesce_width = Histogram(WIDTH_BOUNDS)
        self.chunks_launched = 0
        self._seq = 0
        self._snap = snapshot_mod.derive(doc_id, 0, self.tree,
                                         stats=self.readcache,
                                         shm=engine.shmcache)
        self._prev_snap: Optional[snapshot_mod.DocSnapshot] = None
        # everything restored/replayed so far is durable (or, for
        # non-durable docs, committed) — background spills may cover it
        self._safe_extent = self.tree.log_length
        if engine.maintenance is not None \
                and self.tree._log.tiering_enabled:
            # deferred spill policy: due spills leave the scheduler
            # thread for the maintenance worker, with the hard-cap
            # inline fallback keeping memory bounded when it lags
            maint = engine.maintenance
            hot_bytes = _env_int("GRAFT_OPLOG_HOT_BYTES", 0)
            self.tree._log.set_spill_policy(
                lambda: maint.enqueue("spill", self),
                inline_cb=maint.note_inline_spill,
                hard_cap_ops=engine.oplog_hot_hard_ops,
                # byte-budgeted tails get a byte-denominated cap too
                # (few huge ops never trip the op count)
                hard_cap_bytes=hot_bytes * max(
                    2, _env_int("GRAFT_OPLOG_HOT_HARD_MULT", 8))
                if hot_bytes > 0 else 0)

    def _init_durable(self, engine: "ServingEngine",
                      max_depth: int) -> None:
        """Open (or recover) this document's durable state: tiers from
        the manifest when one exists, then WAL tail replay through the
        ordinary apply path, then a bumped fencing epoch — the
        recovered document is serving-ready the moment construction
        returns (the first snapshot derives below, exactly like a
        fresh doc; a non-empty replay pays the one first-merge
        materialization a restored doc owes anyway)."""
        ddir = os.path.join(engine.durable_dir, f"doc-{self.doc_id}")
        os.makedirs(ddir, exist_ok=True)
        manifest = os.path.join(ddir, "manifest.json")
        had_manifest = os.path.exists(manifest)
        tier_kw = dict(
            hot_ops=max(1, engine.oplog_hot_ops),
            hot_bytes=_env_int("GRAFT_OPLOG_HOT_BYTES", 0),
            gc_min_segs=_env_int("GRAFT_OPLOG_GC_SEGS", 4),
            auto_stable=not engine.external_stability,
            ephemeral=False, durable=True,
            cache=engine.oplog_cache)
        if had_manifest:
            self.tree = engine_mod.TpuTree.restore_tiered(
                ddir, device=engine.device, **tier_kw)
        else:
            self.tree = engine_mod.init(SERVER_REPLICA,
                                        max_depth=max_depth,
                                        device=engine.device)
            if engine.oplog_hot_ops > 0:
                self.tree.enable_log_tiering(ddir, **tier_kw)
        if self.tree._log.tiering_enabled:
            self.tree._log.set_durable_hooks(
                self.tree.manifest_meta, self._on_tier_advance)
        if engine.wal_sync != "off":
            perdoc_path = os.path.join(ddir, "wal.log")
            if engine.shared_wal is not None:
                if os.path.exists(perdoc_path) \
                        and os.path.getsize(perdoc_path) > len(
                            wal_mod.MAGIC):
                    # a per-doc WAL tail from an incarnation without
                    # GRAFT_WAL_SHARED: only the per-doc format can
                    # replay it — ignoring it would drop fsync-acked
                    # writes
                    raise wal_mod.WalError(
                        f"document {self.doc_id!r} holds a non-empty "
                        f"per-doc WAL but the engine runs the shared "
                        f"stream; restart without GRAFT_WAL_SHARED "
                        f"(its acked tail lives only there)")
                # shared stream: this doc's records were pre-scanned
                # out of the engine-wide file at engine construction
                self.wal = wal_mod.DocWalView(
                    engine.shared_wal, self.doc_id,
                    engine._shared_replay.pop(self.doc_id, None))
            else:
                self.wal = wal_mod.Wal(perdoc_path)
            # raises typed WalError on mid-log corruption — a server
            # must never silently serve a partially replayed log
            self.replay_stats = self.wal.replay_into(
                self.tree, engine.chunk_ops)
            # replay-time spills noted truncations; nothing is in
            # flight, so fold them into the file now — and seed the
            # artifact cadence (the replay just built the mirror, so
            # the export is cheap here)
            self.wal_mark_durable()
            self.maybe_write_matz()
        self.recovered = had_manifest or bool(
            (self.replay_stats or {}).get("records"))
        self.epoch = wal_mod.bump_epoch(ddir)

    def _on_tier_advance(self, tiered_len: int) -> None:
        """Spill/fold manifest landed: rows below ``tiered_len`` are
        durable in cold segments.  The WAL prefix they cover is
        dropped at the NEXT successful fsync (:meth:`wal_mark_durable`
        — steady-state WAL size stays O(hot tail)); truncating here
        could strand a WAL-shed rollback that reloads hot rows out of
        a straddling segment the spill just sealed."""
        self._wal_truncate_pending = True

    def wal_mark_durable(self) -> None:
        """Everything in the log is now fsync-durable (tiers ∪ synced
        WAL) and no rollback is possible — safe to drop the WAL prefix
        the tiers cover.  Called by the scheduler after each
        successful fsync, and once after recovery replay.  A FAILED
        truncation (tmp-rewrite ENOSPC mid-compaction) is deferred and
        retried at the next barrier — the covered commits are already
        durable, so it must never surface as their error."""
        if self.wal is not None and self._wal_truncate_pending:
            try:
                self.wal.truncate_below(self.tree._log.tiered_extent)
            except OSError:
                self._engine.counters.add("wal_truncate_errors")
                return              # keep the pending flag; retry
            self._wal_truncate_pending = False

    def maybe_write_matz(self) -> None:
        """Refresh the materialization artifact once the log has grown
        ``GRAFT_MATZ_TAIL_OPS`` past the last one (restore-side tail
        replay stays bounded by this cadence).  Called by the
        scheduler at the END of a round — AFTER every ticket resolved
        (the commit is already durable; an O(document) artifact
        export must never sit between a client and its ack) — and
        once after recovery replay.  Skips silently when the mirror
        is not cheaply derivable — the artifact is an accelerator,
        never a new cold-path cost on the commit path."""
        if self.wal is None or self._engine.matz_tail_ops <= 0 \
                or not engine_mod.matz_enabled():
            return
        log = self.tree._log
        if not log.tiering_enabled:
            return
        entry = log.matz_entry
        covered = int(entry["len"]) if entry is not None else 0
        if self.tree.log_length - covered < self._engine.matz_tail_ops:
            return
        # the artifact write spills the whole hot tail first; the WAL
        # prefix the new manifest covers drops at the next barrier
        # (the usual deferred-truncation rule)
        self.tree.write_matz()

    def run_scrub(self) -> Dict:
        """One scrub pass (maintenance-lane thread): checksum sweep of
        every cold segment, base chunk, and the matz artifact; corrupt
        tier files quarantine (typed refusals until healed) and, when
        the engine has a fleet ``repair_fetcher`` (cluster/gateway.py),
        each quarantined range is re-fetched from a peer through the
        ordinary window machinery and re-sealed in place.  Pure numpy
        + file + HTTP I/O — no CUDA tensor, maintenance-lane safe."""
        log = self.tree._log
        if not log.tiering_enabled:
            return {}
        report = log.scrub()
        st = self.scrub_stats
        st["runs"] += 1
        st["checked"] += report.get("checked", 0)
        st["corrupt"] += report.get("corrupt", 0)
        st["matz_dropped"] += report.get("matz_dropped", 0)
        # WAL-stream scrub: walk the live stream's
        # record framing + crc32 on the same cadence, so mid-log damage
        # (real corruption — a typed WalError at recovery) is surfaced
        # by prom + a flight dump NOW instead of first discovered when
        # the process restarts.  A torn TAIL at scrub time is benign:
        # either a crash leftover recovery would drop anyway, or an
        # append racing the sweep — counted, never dumped on.  Shared-
        # stream engines verify the ONE stream once per sweep cadence
        # (engine-level latch), not once per document — the counters
        # land on whichever doc's scrub drew the sweep.
        if self.wal is not None:
            if isinstance(self.wal, wal_mod.DocWalView):
                v = self._engine.verify_shared_wal_once()
            else:
                v = self.wal.verify()
            if v is not None:
                st["wal_records"] += v["records"]
                st["wal_torn_tail"] += v["torn_tail"]
                if v["mid_log"]:
                    st["wal_mid_log"] += v["mid_log"]
                    self._engine.counters.add("wal_scrub_mid_log")
                    try:
                        self._engine.flight.dump(
                            reason="wal-corruption")
                    except Exception:  # noqa: BLE001 — recorder boundary
                        pass
        fetcher = self._engine.repair_fetcher
        for seg in log.quarantined_segments():
            if fetcher is None:
                # single node: nothing to heal from — the quarantine
                # stands as a typed error on touch (never wrong
                # data).  NOT counted as a failed repair: no attempt
                # was made, and the standing condition is already the
                # quarantined gauge — repair_failed must keep meaning
                # "a peer fetch was tried and didn't work"
                continue
            spec = log.repair_spec(seg)
            if spec is None:
                continue            # raced a concurrent repair
            rows = fetcher(self.doc_id, spec)
            if rows is not None and log.repair_segment(seg, rows):
                st["repaired"] += 1
            else:
                st["repair_failed"] += 1
        return report

    # -- snapshot publication (scheduler thread only) ---------------------

    def publish(self) -> float:
        """Derive and swap in the next snapshot from the just-committed
        tree.  Single writer (the scheduler), so ``seq`` is strictly
        monotone; the attribute store is the linearization point.
        Returns the OUTGOING snapshot's age — the read staleness this
        publish just retired, stamped on the commit's flight record.
        Under fault injection only, the outgoing snapshot is retained
        one generation as the stale/regress target (obs/oracle.py)."""
        self._prepared_seq += 1
        return self.publish_prepared(snapshot_mod.derive(
            self.doc_id, self._prepared_seq, self.tree,
            stats=self.readcache, shm=self._engine.shmcache))

    def prepare_publish(self) -> snapshot_mod.DocSnapshot:
        """Pipelined commit path, compute half (scheduler thread):
        derive — but do NOT publish — the snapshot this commit's fsync
        will publish.  The derived snapshot is immutable and pins a
        reference-stable ``LogView``, so the WAL-sync worker's later
        :meth:`publish_prepared` is a pointer swap that cannot race
        the merges the scheduler runs meanwhile.  A shed commit's
        prepared snapshot is simply discarded (seq gaps are legal —
        monotonicity is all readers rely on)."""
        self._prepared_seq += 1
        return snapshot_mod.derive(self.doc_id, self._prepared_seq,
                                   self.tree, stats=self.readcache,
                                   shm=self._engine.shmcache)

    def publish_prepared(self, snap: snapshot_mod.DocSnapshot) -> float:
        """Swap in a :meth:`prepare_publish` snapshot — the
        linearization point, called by whichever thread completed the
        commit's fsync (WAL-sync worker, or the scheduler itself on
        the serialized path via :meth:`publish`)."""
        staleness = self._snap.age_s()
        outgoing = self._snap
        if self._engine.fault is not None:
            # only fault injection ever serves the previous generation
            # (read_view); in production retaining it would double the
            # per-document snapshot footprint for nothing
            self._prev_snap = self._snap
        self._seq = snap.seq
        self._snap = snap
        # wake parked watchers (serve/watch.py) AFTER the swap: a
        # woken watcher re-reads the published pointer, so it can only
        # ever serve this generation or a newer one — and because
        # every durable mode calls publish_prepared strictly after the
        # commit's fsync resolved, a watcher can never be shown a
        # generation whose fsync could still roll back
        self.watch.notify(snap.seq)
        # host-shared body tier (serve/shmcache.py): the swap IS the
        # invalidation — release the outgoing generation's segment
        # claim off-thread (manifest flock I/O must not ride the
        # publish path); readers still holding its memoryviews stay
        # valid by the unlink-under-mmap contract
        seg_name = outgoing.shm_seg_name
        if seg_name is not None:
            shm, maint = self._engine.shmcache, self._engine.maintenance
            if shm is not None and not (
                    maint is not None
                    and maint.enqueue("shmrel", self,
                                      payload=seg_name)):
                shm.release(seg_name)
        return staleness

    def safe_extent(self) -> int:
        """The log extent no failed group fsync can roll back — the
        background maintenance worker's spill bound."""
        return self._safe_extent

    def note_durable(self, log_len: int,
                     matz_check: bool = True) -> None:
        """A commit through ``log_len`` fully resolved (fsynced, or
        not WAL-deferred at all): advance the spill-safe extent, and
        check the matz cadence — a due refresh raises ``_matz_due``
        for the scheduler's next safe pickup (the pipelined twin of
        :meth:`maybe_write_matz`)."""
        if log_len > self._safe_extent:
            self._safe_extent = log_len
        if not matz_check or self._matz_due:
            return
        if self.wal is None or self._engine.matz_tail_ops <= 0 \
                or not engine_mod.matz_enabled() \
                or not self.tree._log.tiering_enabled:
            return
        entry = self.tree._log.matz_entry
        covered = int(entry["len"]) if entry is not None else 0
        if log_len - covered >= self._engine.matz_tail_ops:
            self._matz_due = True

    def snapshot_view(self) -> snapshot_mod.DocSnapshot:
        """The current published snapshot (lock-free)."""
        return self._snap

    def read_view(self) -> snapshot_mod.DocSnapshot:
        """The snapshot a READ endpoint should serve: normally the
        published snapshot, but under armed ``stale``/``regress``
        fault injection (``GRAFT_ORACLE_FAULT``, obs/oracle.py) ONE
        read is deliberately served the previous generation so the
        session-guarantee oracle's detection path is proven against a
        real violation, not a simulated one."""
        fault = self._engine.fault
        if fault is not None and self._prev_snap is not None and (
                fault.pop("stale") or fault.pop("regress")):
            return self._prev_snap
        return self._snap

    # -- Document-compatible read API (all lock-free) ---------------------

    def snapshot(self) -> List:
        return self._snap.visible_values()

    def dumps_since_bytes(self, ts: int) -> bytes:
        return self._snap.ops_since_bytes(ts)

    def ops_since_window(self, ts: int, limit: int = 0):
        """Windowed anti-entropy pull (``GET /ops?since=&limit=``) off
        the published snapshot — cluster/antientropy.py's wire."""
        return self._snap.ops_since_window(ts, limit)

    def ops_window_plan(self, since: int, limit: int = 0):
        """Zero-copy serving plan for a cold catch-up window
        (oplog.LogView.window_plan; docs/SERVING.md §Zero-copy
        egress): ``(chunks, total_len, meta)`` with ``meta`` carrying
        the SAME quoted-sha1 ``etag`` the buffered path serves for
        these bytes, or None when the window must go buffered (hot
        rows in range, an untiered log, sidecars still building).
        Sidecars found missing are handed to the maintenance lane
        here — the NEXT pull of this window goes zero-copy — or built
        inline when no worker runs.  The returned tuple carries the
        snapshot the plan was built from as its 4th element: the
        CALLER must hold it until the send completes, because the
        pinned view is what keeps every planned segment file (and
        sidecar — tomb GC deletes both together) alive across a
        concurrent publish/fold."""
        sf = self._engine.sendfile_stats
        if sf is None or limit <= 0:
            return None
        snap = self._snap
        view = snap.view
        if not hasattr(view, "window_plan"):
            return None
        plan, missing = view.window_plan(since, limit)
        if missing:
            maint = self._engine.maintenance
            for seg in missing:
                seg.wire = "building"
                if maint is None or not maint.enqueue(
                        "wire", self, payload=seg):
                    ok = oplog_mod.ensure_wire_sidecar(seg)
                    sf.add("sidecar_builds" if ok
                           else "sidecar_build_failures")
            if maint is None:
                plan, missing = view.window_plan(since, limit)
        if plan is None:
            sf.add("fallback")
            return None
        chunks, total, meta = plan
        etag = oplog_mod.plan_etag(chunks)
        if etag is None:
            sf.add("fallback")
            return None
        meta = dict(meta)
        meta["etag"] = etag
        return chunks, total, meta, snap

    @property
    def sendfile_stats(self):
        return self._engine.sendfile_stats

    def snapshot_packed(self) -> bytes:
        return self._snap.checkpoint_bytes()

    def clock(self) -> Dict[str, int]:
        return self._snap.clock_wire()

    def assign_replica(self) -> int:
        with self._replica_lock:
            rid = self.next_replica
            self.next_replica += 1
            return rid

    def apply_body(self, body,
                   trace_id: Optional[str] = None
                   ) -> Tuple[bool, Operation]:
        """Document-compatible write entry: enqueue, await the commit.
        Raises :class:`QueueFull` under backpressure (the handler's 429)
        and decode errors immediately (400), exactly like the inline
        path raised them.  ``trace_id``: the id minted at HTTP
        admission (obs/trace.py); one is minted here for embedded
        callers that pass none."""
        return self._engine.submit(self.doc_id, body, trace_id=trace_id)

    def retry_after_s(self) -> int:
        """Drain-time estimate for the Retry-After header, from this
        document's own recent commit latency and queue depth."""
        h = self.commit_ms.snapshot()
        p50_ms = h.get("p50") or 50.0
        est = (len(self.queue) + 1) * p50_ms / 1000.0
        return max(1, min(30, int(est + 0.999)))

    def metrics(self) -> Dict:
        snap = self._snap
        oplog_tele = self.tree._log.telemetry()
        return {
            "ops_merged": self.ops_merged,
            "dup_absorbed": self.dup_absorbed,
            "batches_rejected": self.batches_rejected,
            "num_visible": len(snap.values),
            "log_length": snap.log_length,
            "replicas_assigned": self.next_replica - 1,
            # scheduler observability (queue depth, coalesce width,
            # chunk count, commit latency, snapshot age)
            "queue_depth": len(self.queue),
            "queue_leaves": self.queue.pending_leaves(),
            "admission_rejected": self.admission_rejected,
            "snapshot_seq": snap.seq,
            "snapshot_age_s": round(snap.age_s(), 3),
            "log_segments": snap.log_segments,
            "chunks_launched": self.chunks_launched,
            "commit_latency_ms": self.commit_ms.snapshot(),
            "coalesce_width": self.coalesce_width.snapshot(),
            # cascade op-log tier state (oplog.py; docs/OPLOG.md)
            "oplog": oplog_tele,
            # crash durability (wal.py; docs/DURABILITY.md)
            "durable": self._engine.durable_dir is not None,
            "epoch": self.epoch,
            "recovered": self.recovered,
            "wal": None if self.wal is None else self.wal.telemetry(),
            # persisted materialization (docs/DURABILITY.md §Cold
            # paths): artifact writes/loads/fallbacks + coverage
            "matz": dict(self.tree.matz_stats,
                         len=oplog_tele["matz_len"])
            if self._engine.durable_dir is not None else None,
            # scrub & repair (docs/DURABILITY.md §Scrub & repair)
            "scrub": dict(self.scrub_stats,
                          quarantined=oplog_tele.get("quarantined", 0))
            if self.tree._log.tiering_enabled else None,
            # encoded-body read cache (serve/snapshot.py)
            "readcache": self.readcache.snapshot(),
            # delta-push fan-out (serve/watch.py)
            "watch": self.watch.snapshot(),
        }


class ServingEngine:
    """All documents hosted by this server, plus the merge scheduler.

    DocumentStore-compatible (``get``/``ids``/``encode_ops``/
    ``decode_ops``), so ``service.http.make_server`` serves either."""

    def __init__(self, max_depth: int = 16, *,
                 max_queue_requests: int = 256,
                 max_queue_leaves: int = 4_000_000,
                 chunk_ops: int = DEFAULT_CHUNK_OPS,
                 cross_doc: bool = True,
                 wire_fast_bytes: int = WIRE_FAST_BYTES,
                 submit_timeout_s: float = 600.0,
                 oplog_hot_ops: Optional[int] = None,
                 oplog_dir: Optional[str] = None,
                 readcache: bool = True,
                 sendfile: bool = True,
                 readcache_windows: Optional[int] = None,
                 shmcache: Optional[bool] = None,
                 watch_max: Optional[int] = None,
                 reactor: bool = True,
                 durable_dir: Optional[str] = None,
                 wal_sync: Optional[str] = None,
                 wal_sync_backend: Optional[str] = None,
                 wal_shared: Optional[bool] = None,
                 pipeline: bool = True,
                 flight: Optional[flight_mod.FlightRecorder] = None,
                 fault: Optional[oracle_mod.FaultInjector] = None,
                 mergetier=None,
                 device=None,
                 start: bool = True):
        from .scheduler import MergeScheduler
        from .workers import MaintenanceWorker, WalSyncWorker
        # every served document merges on this device: the card unless
        # the caller names another; no card and no device= raises
        self.device = merge_mod.resolve_device(device)
        # the reference's A/B baselines are not environment switches
        # here: the port keeps each switch's default path, and the
        # baselines it runs are the constructor arguments above
        for name, default in _UNPORTED_SWITCHES:
            raw = os.environ.get(name)
            if raw is not None and _env_on(name, "") != default:
                raise NotImplementedError(
                    f"{name}={raw.strip()!r} is not ported as an "
                    f"environment switch; the port keeps its default "
                    f"path (the READCACHE, SENDFILE, REACTOR and "
                    f"PIPELINE baselines are ServingEngine arguments)")
        self._docs: Dict[str, ServedDoc] = {}
        self._lock = threading.Lock()
        self._max_depth = max_depth
        # cascade op-log (oplog.py): on by default; 0 disables.  The
        # spill scratch dir is per-engine (one subdir per document) and
        # removed with the engine when it was auto-created.
        self.oplog_hot_ops = oplog_hot_ops if oplog_hot_ops is not None \
            else _env_int("GRAFT_OPLOG_HOT_OPS", DEFAULT_OPLOG_HOT_OPS)
        # encoded-body read cache (serve/snapshot.py): each published
        # generation encodes a wire body at most once.  readcache=False
        # is the per-request re-encode baseline (wire bytes identical)
        self.readcache_enabled = bool(readcache)
        self.readcache_windows = readcache_windows \
            if readcache_windows is not None \
            else _env_int("GRAFT_READCACHE_WINDOWS",
                          snapshot_mod.DEFAULT_WINDOW_LRU)
        # host-shared encoded-body tier (serve/shmcache.py): off by
        # default — GRAFT_SHMCACHE=1 arms it on a many-process host so
        # N processes serve ONE copy of each generation's whole-doc
        # bodies.  A disabled read cache bypasses both tiers;
        # construction failure (no POSIX shm) degrades to the
        # process-local read cache.
        if shmcache is None:
            shmcache = _env_on("GRAFT_SHMCACHE", "0")
        self.shmcache = None
        if shmcache and self.readcache_enabled:
            from . import shmcache as shmcache_mod
            try:
                self.shmcache = shmcache_mod.ShmBodyCache()
                self.shmcache.scavenge()
            except (OSError, AttributeError):
                self.shmcache = None
        # zero-copy cold egress (oplog.py wire sidecars) wherever the
        # cascade tiers logs: a catch-up /ops window that lands
        # entirely on cold segments ships as os.sendfile ranges over
        # precomputed wire sidecars.  sendfile=False is the buffered
        # load→encode cold path (the A/B baseline; the same wire bytes)
        self.sendfile_stats: Optional[Counters] = \
            Counters() if sendfile and self.oplog_hot_ops > 0 else None
        # delta-push fan-out (serve/watch.py): per-doc
        # parked-watcher cap (429 past it), long-poll park budget
        # ceiling, SSE heartbeat cadence
        self.watch_max = watch_max if watch_max is not None \
            else _env_int("GRAFT_WATCH_MAX", watch_mod.DEFAULT_WATCH_MAX)
        self.watch_park_s = _env_float("GRAFT_WATCH_PARK_S",
                                       watch_mod.DEFAULT_PARK_S)
        self.watch_heartbeat_s = _env_float(
            "GRAFT_WATCH_HEARTBEAT_S", watch_mod.DEFAULT_HEARTBEAT_S)
        # reactor egress (serve/reactor.py): a caught-up watch
        # connection detaches from its handler thread onto one of
        # GRAFT_REACTOR_THREADS selector loops (lazy-started at the
        # first park; hard-capped at 4).  reactor=False is the
        # thread-per-parked-watcher baseline (same wire bytes).  A
        # reactor that fails to build raises: an engine asked for one
        # never parks on threads instead.
        self.reactor = None
        if reactor:
            from . import reactor as reactor_mod
            self.reactor = reactor_mod.Reactor(
                threads=_env_int("GRAFT_REACTOR_THREADS",
                                 reactor_mod.DEFAULT_THREADS),
                buf_cap=_env_int("GRAFT_REACTOR_BUF",
                                 reactor_mod.DEFAULT_BUF_CAP))
        # crash durability (wal.py; docs/DURABILITY.md): a durable_dir
        # puts every document's tiers + WAL in a persistent per-doc
        # subdir; acked writes then survive a kill (fsync-before-ack,
        # GRAFT_WAL_SYNC=commit|batch; "off" keeps the durable tier
        # dirs but no WAL — the bench baseline).  Pre-existing doc
        # dirs under it are recovered to serving at construction.
        self.durable_dir = durable_dir \
            or os.environ.get("GRAFT_DURABLE_DIR") or None
        self.wal_sync = wal_sync if wal_sync is not None \
            else wal_mod.sync_mode_from_env()
        if self.wal_sync not in wal_mod.SYNC_MODES:
            raise ValueError(f"wal_sync {self.wal_sync!r} not in "
                             f"{wal_mod.SYNC_MODES}")
        # shared group-commit WAL (GRAFT_WAL_SHARED; docs/DURABILITY.md
        # §Shared WAL): every durable document's records multiplex into
        # ONE per-engine stream and one fsync per scheduler round
        # covers all of them — a many-doc node stops paying one fsync
        # stream per document.  Recovery pre-scans the stream once and
        # hands each document its own record list.  The stream's bytes
        # are the reference's: either package recovers the other's.
        if wal_shared is None:
            wal_shared = _env_on("GRAFT_WAL_SHARED", "0")
        self.shared_wal: Optional[wal_mod.SharedWal] = None
        self._shared_replay: Dict[str, list] = {}
        if self.durable_dir is not None and self.wal_sync != "off":
            os.makedirs(self.durable_dir, exist_ok=True)
            shared_path = os.path.join(self.durable_dir,
                                       "wal-shared.log")
            if wal_shared:
                self.shared_wal = wal_mod.SharedWal(shared_path)
                # raises typed WalError on mid-log corruption — never
                # a silent partial recovery
                self._shared_replay = self.shared_wal.recover_records()
            elif os.path.exists(shared_path) \
                    and os.path.getsize(shared_path) > len(
                        wal_mod.SHARED_MAGIC):
                # the previous incarnation ran GRAFT_WAL_SHARED and
                # left records only this format can replay — silently
                # ignoring them would drop fsync-acked writes
                raise wal_mod.WalError(
                    f"durable dir {self.durable_dir!r} holds a "
                    f"non-empty shared WAL stream but this engine "
                    f"was started without GRAFT_WAL_SHARED; restart "
                    f"with the previous mode (its acked tail lives "
                    f"only there)")
        # persisted-materialization cadence (docs/DURABILITY.md §Cold
        # paths): once a durable doc's log grows this far past its
        # artifact, the next round-end refresh rewrites it (0 = off)
        self.matz_tail_ops = _env_int("GRAFT_MATZ_TAIL_OPS", 65536)
        # ONE segment/chunk LRU for the whole engine: the
        # GRAFT_OPLOG_CACHE_MB byte budget bounds every served doc's
        # paged-in cold bytes TOGETHER (a per-doc budget would admit
        # 256 MB × docs resident on a many-doc node)
        from ..oplog import make_seg_cache
        self.oplog_cache = make_seg_cache(
            cap=_env_int("GRAFT_OPLOG_CACHE_SEGS", 2))
        self._own_oplog_dir = False
        self.oplog_dir = oplog_dir or os.environ.get("GRAFT_OPLOG_DIR")
        if self.oplog_hot_ops > 0 and self.oplog_dir is None \
                and self.durable_dir is None:
            import tempfile
            self.oplog_dir = tempfile.mkdtemp(prefix="graft-oplog-")
            self._own_oplog_dir = True
        # a fleet gateway flips this ON before traffic so served logs
        # wait for explicit anti-entropy stability watermarks instead
        # of auto-stabilizing (cluster/gateway.py)
        self.external_stability = False
        self.max_queue_requests = max_queue_requests
        self.max_queue_leaves = max_queue_leaves
        self.chunk_ops = chunk_ops
        self.cross_doc = cross_doc
        self.wire_fast_bytes = wire_fast_bytes
        self.submit_timeout_s = submit_timeout_s
        self.counters = Counters()
        # the flight recorder is process-wide by default (like the span
        # registry): every commit resolved by this engine lands one
        # record, and dumps trigger on SLO breach / audit failure /
        # engine error (obs/flight.py; docs/OBSERVABILITY.md)
        self.flight = flight if flight is not None \
            else flight_mod.get_default_recorder()
        # fault injection for the session-guarantee oracle's CI proof
        # (GRAFT_ORACLE_FAULT; obs/oracle.py) — None in production
        self.fault = fault if fault is not None \
            else oracle_mod.FaultInjector.from_env()
        # a SessionOracle attached via oracle.attach_engine() — renders
        # the crdt_oracle_* prom families when present
        self.oracle: Optional[oracle_mod.SessionOracle] = None
        # fleet-wide tracing + visibility ledger (obs/fleettrace.py,
        # obs/ledger.py): a ClusterNode wires both; single-engine
        # deployments leave them None and record_commit pays nothing
        self.fleettrace = None
        self.ledger = None
        # scrub-with-peer-repair (docs/DURABILITY.md §Scrub & repair):
        # the maintenance worker sweeps each tiered doc's cold files
        # on this cadence (0 = off; the fleet __main__ arms it);
        # repair_fetcher is installed by a ClusterNode — single-node
        # engines quarantine without healing (typed error on touch)
        self.scrub_interval_s = _env_float("GRAFT_SCRUB_INTERVAL_S",
                                           0.0)
        self.repair_fetcher = None
        # shared-WAL scrub latch: many docs share ONE stream, so the
        # framing+crc sweep runs at most once per cadence engine-wide
        self._shared_scrub_mu = threading.Lock()
        self._shared_scrub_at = 0.0
        # size/age spill-policy knobs (maintenance worker policy tick)
        self.oplog_hot_age_s = _env_float("GRAFT_OPLOG_HOT_AGE_S", 0.0)
        self.oplog_resident_bytes = _env_int(
            "GRAFT_OPLOG_RESIDENT_MB", 0) << 20
        # inline-spill hard cap: past this many resident hot ops the
        # scheduler spills inline even with the worker armed — memory
        # stays bounded no matter how far the worker lags
        self.oplog_hot_hard_ops = max(1, self.oplog_hot_ops) * max(
            2, _env_int("GRAFT_OPLOG_HOT_HARD_MULT", 8))
        # the commit pipeline's background lanes (serve/workers.py).
        # ``pipeline=False`` runs every round serialized on the
        # scheduler thread (compute → fsync → publish → maintenance):
        # the reference's baseline, kept as an argument so its crash
        # matrix replays here; the GRAFT_PIPELINE=0 switch stays
        # unported.
        self.maintenance = None
        self.sync_worker = None
        if pipeline and (self.oplog_hot_ops > 0
                         or self.durable_dir is not None):
            self.maintenance = MaintenanceWorker(self)
        if pipeline and self.durable_dir is not None \
                and self.wal_sync == "batch":
            # fan-out backend for the group-commit fsync stage
            # (GRAFT_WAL_SYNC_BACKEND=auto|uring|workers|single;
            # docs/DURABILITY.md §Sync backends)
            self.sync_worker = WalSyncWorker(
                self, backend=wal_sync_backend)
        if self.shared_wal is not None and self.maintenance is not None:
            maint = self.maintenance
            self.shared_wal.set_compact_cb(
                lambda: maint.enqueue("compact"))
        # disaggregated merge tier (mergetier/; docs/MERGETIER.md):
        # off unless a client (or worker list) is handed in or
        # GRAFT_MERGETIER arms one from GRAFT_MERGETIER_WORKERS.
        # GRAFT_MERGETIER=0 EXPLICITLY set is the kill switch and
        # overrides even an explicit client — every crdt_mergetier_*
        # family then disappears and merges run the local path.
        # Construction failure degrades to local-only serving.
        from ..mergetier import client as mergetier_mod
        self.mergetier: Optional[mergetier_mod.MergeTierClient] = None
        if not mergetier_mod.tier_killed():
            try:
                if mergetier is not None:
                    if isinstance(mergetier,
                                  mergetier_mod.MergeTierClient):
                        self.mergetier = mergetier
                    else:
                        self.mergetier = mergetier_mod.MergeTierClient(
                            list(mergetier))
                elif mergetier_mod.tier_enabled():
                    self.mergetier = \
                        mergetier_mod.MergeTierClient.from_env()
            except (ValueError, OSError):
                self.mergetier = None
        self.scheduler = MergeScheduler(self)
        # workers start before recovery: recovered docs arm their
        # spill policies against them at construction
        if self.maintenance is not None:
            self.maintenance.start()
        if self.sync_worker is not None:
            self.sync_worker.start()
        # recovery-to-serving: reopen every durable document found on
        # disk NOW, so a restarted server answers reads (and accepts
        # writes at its bumped epoch) immediately instead of 404ing
        # until first access.  Raises typed WalError/CheckpointError
        # on real corruption — never a silent partial recovery.
        if self.durable_dir is not None:
            os.makedirs(self.durable_dir, exist_ok=True)
            for name in sorted(os.listdir(self.durable_dir)):
                if name.startswith("doc-") and os.path.isdir(
                        os.path.join(self.durable_dir, name)):
                    self.get(name[len("doc-"):])
        if start:
            self.scheduler.start()

    def verify_shared_wal_once(self) -> Optional[Dict]:
        """One framing+crc walk of the shared WAL stream, deduped to
        at most once per scrub cadence across ALL documents (each
        doc's scrub task would otherwise re-scan the whole engine-wide
        file N times per sweep — and report one corruption N times).
        Returns the verify dict, or None when this cadence's sweep
        already ran (the caller adds nothing)."""
        if self.shared_wal is None:
            return None
        window = max(self.scrub_interval_s, 0.0)
        now = time.monotonic()
        with self._shared_scrub_mu:
            if window > 0.0 and now - self._shared_scrub_at < window:
                return None
            self._shared_scrub_at = now
        return self.shared_wal.verify()

    # -- store surface ----------------------------------------------------

    def get(self, doc_id: str, create: bool = True) -> Optional[ServedDoc]:
        with self._lock:
            doc = self._docs.get(doc_id)
            if doc is None and create:
                doc = self._docs[doc_id] = ServedDoc(
                    doc_id, self, self._max_depth)
            return doc

    def ids(self) -> List[str]:
        with self._lock:
            return sorted(self._docs)

    def docs(self) -> List[ServedDoc]:
        with self._lock:
            return list(self._docs.values())

    @staticmethod
    def encode_ops(op: Operation) -> str:
        return json_codec.dumps(op)

    @staticmethod
    def decode_ops(payload) -> Operation:
        return json_codec.loads(payload)

    # -- write path -------------------------------------------------------

    def _parse(self, body) -> Tuple[packed_mod.PackedOps, int]:
        """Wire body → packed delta (handler thread; decode errors
        propagate to the caller's 400)."""
        from .. import native
        if isinstance(body, str):
            body = body.encode()
        if len(body) < self.wire_fast_bytes or not native.available():
            leaves = list(op_mod.iter_leaves(json_codec.loads(body)))
            return (packed_mod.pack(leaves, max_depth=self._max_depth),
                    len(leaves))
        p = native.parse_pack(body, max_depth=self._max_depth)
        return p, p.num_ops

    def submit(self, doc_id: str, body,
               trace_id: Optional[str] = None) -> Tuple[bool, Operation]:
        """Parse, admit, and await the merge of one client delta.
        Returns ``(accepted, applied_ops)`` like ``Document.apply_body``;
        raises :class:`QueueFull` (→ 429) or :class:`SchedulerStopped`
        (→ 503).  ``trace_id`` (minted at HTTP admission, or here for
        embedded callers) rides the ticket into the fused commit's
        flight record."""
        from ..utils import profiling
        tid = trace_mod.ensure_trace_id(trace_id)
        doc = self.get(doc_id)
        # shed at the door BEFORE paying the parse: a saturated queue
        # must not cost a full native parse (up to max_body) per
        # rejected retry.  Racy pre-check only — the authoritative
        # depth/leaves check is offer(), under the scheduler condition.
        if len(doc.queue) >= doc.queue.max_requests:
            doc.admission_rejected += 1
            raise QueueFull(doc_id, len(doc.queue), doc.retry_after_s())
        t0 = time.perf_counter()
        with profiling.span("serve.parse"):
            packed, n = self._parse(body)
        ticket = WriteTicket(packed, n, trace_id=tid,
                             parse_ms=(time.perf_counter() - t0) * 1e3)
        sched = self.scheduler
        with sched.cond:
            if sched.stopped:
                raise SchedulerStopped("serving engine is shut down")
            try:
                doc.queue.offer(ticket, doc.retry_after_s(), doc_id)
            except QueueFull:
                doc.admission_rejected += 1
                raise
            sched.cond.notify_all()
        ticket.wait(self.submit_timeout_s)
        return ticket.accepted, ticket.applied_op

    # -- ticket attribution (scheduler thread) ----------------------------

    def finish_ticket(self, doc: ServedDoc, t: WriteTicket,
                      mask: np.ndarray) -> None:
        """Record one accepted ticket's outcome from its applied-leaf
        mask (the engine's per-row attribution for fused batches)."""
        applied = int(mask.sum())
        t.accepted = True
        t.applied_count = applied
        doc.ops_merged += applied
        doc.dup_absorbed += t.n_leaves - applied
        if applied == 0:
            t.applied_op = Batch(())
            return
        if applied == t.n_leaves:
            sel = t.packed
        else:
            sel = packed_mod.select_rows(t.packed, np.nonzero(mask)[0])
        if applied <= ECHO_LIMIT:
            ops = packed_mod.unpack_rows(sel, 0, applied)
            # single-leaf deltas echo the bare op (Document.apply parity)
            t.applied_op = ops[0] if t.n_leaves == 1 else \
                Batch(tuple(ops))
        else:
            # count-only consumers read num_leaves; nothing materializes
            t.applied_op = PackedBatch(sel, 0, applied)

    def reject_ticket(self, doc: ServedDoc, t: WriteTicket) -> None:
        doc.batches_rejected += 1
        t.accepted = False
        t.applied_count = 0
        t.applied_op = Batch(())

    # -- flight recording (scheduler thread) ------------------------------

    def record_commit(self, doc: ServedDoc,
                      ct: trace_mod.CommitTrace) -> None:
        """Finalize one commit's :class:`~crdt_graph_tpu_torch.obs.trace.
        CommitTrace` into the flight recorder: stamp the published
        snapshot's seq + fingerprint, attach the sampled chain audit
        every Nth commit, and let the recorder fire its dump triggers.
        Never raises — observability must not take down the scheduler
        (a failed audit sample is recorded, not propagated)."""
        if ct.outcome == "dropped":
            # injected dropped-ack fault (obs/oracle.py): the tickets
            # were acked but the commit intentionally left NO publish
            # and NO flight record — the oracle must find the hole
            self.counters.add("fault_dropped_commits")
            return
        audit = None
        if ct.audit_sampled:
            # sampled on the scheduler thread: around the commit's own
            # merge (audit_commit) or at prepare time (presample_audit)
            # — the WAL-sync worker never runs an audit
            audit = ct.audit_result
        elif (ct.packed is not None and ct.outcome in
                ("committed", "partial")
                and self.flight.audit_due(ct.num_ops)):
            audit = self._audit_second_merge(ct)
        if isinstance(audit, dict):
            # the summary carries the round's batched-launch width
            # (local group size or the merge worker's cross-fleet
            # width): shape and utilization evidence in ONE record
            audit = {**audit, "batch_width": ct.batch_width}
        try:
            snap = doc.snapshot_view()
            self.flight.record({
                "doc_id": ct.doc_id,
                "trace_ids": ct.trace_ids,
                "outcome": ct.outcome,
                "num_ops": ct.num_ops,
                "applied_ops": ct.applied_ops,
                "dup_ops": ct.dup_ops,
                "coalesce_width": ct.n_tickets,
                "batch_width": ct.batch_width,
                "chunk_count": ct.chunk_count,
                "queue_depth_admission": ct.queue_depth_admission,
                "stages_ms": ct.stage_breakdown(),
                "total_ms": round(ct.total_ms, 3),
                "staleness_s": None if ct.staleness_s is None
                else round(ct.staleness_s, 4),
                "snapshot_seq": snap.seq,
                "fingerprint": snap.fingerprint(),
                "audit": audit,
                "error": ct.error,
                # persisted materialization: did the recovered doc's
                # first read come off the artifact?  (None for
                # non-recovered/non-durable docs)
                "matz_hit": (doc.tree.matz_stats["loads"] > 0)
                if doc.recovered else None,
            })
        except Exception:            # noqa: BLE001 — recorder boundary
            self.counters.add("flight_record_errors")
        self.stamp_visibility(doc, ct, ct.total_ms)

    def stamp_visibility(self, doc: ServedDoc, ct: trace_mod.CommitTrace,
                         total_ms: float) -> None:
        """The commit's fleet stamps (:meth:`_stamp_visibility`), once:
        the scheduler calls this just before a committed round's
        tickets resolve, so a client holding its ack finds the commit's
        ledger entry and spans already there (a watch or a scrape right
        after the ack cannot miss them); :meth:`record_commit` stamps
        any commit that reached it unstamped."""
        if ct.visibility_stamped or (self.fleettrace is None
                                     and self.ledger is None):
            return
        ct.visibility_stamped = True
        try:
            self._stamp_visibility(doc, ct, total_ms)
        except Exception:        # noqa: BLE001 — same boundary:
            # tracing must never take down the scheduler
            self.counters.add("fleettrace_stamp_errors")

    def _stamp_visibility(self, doc: ServedDoc, ct: trace_mod.CommitTrace,
                          total_ms: float) -> None:
        """Fleet-node commit stamping (docs/OBSERVABILITY.md §Fleet
        tracing & visibility ledger): register the local admission →
        fsync → publish spans for every trace id the fused commit
        served, append the visibility-ledger entry, and fold the
        trace ids into the doc's anti-entropy trace frontier — ONE
        seam, the same one that feeds the flight recorder."""
        from ..obs import fleettrace as fleettrace_mod
        if not fleettrace_mod.enabled() \
                or ct.outcome not in ("committed", "partial"):
            return
        stages = ct.stage_breakdown()
        wal_ms = sum(v for k, v in stages.items()
                     if k.startswith("wal_"))
        durable_ms = round(wal_ms, 3) if wal_ms > 0.0 else None
        seq = doc.snapshot_view().seq
        total_ms = round(total_ms, 3)
        ft = self.fleettrace
        if ft is not None:
            for tid in ct.trace_ids:
                ft.record(tid, "admission", doc=ct.doc_id, seq=seq)
                if durable_ms is not None:
                    ft.record(tid, "fsync", ms=durable_ms)
                ft.record(tid, "publish", ms=total_ms, seq=seq)
            ft.note_commit(ct.doc_id, ct.trace_ids)
        if self.ledger is not None:
            early = self.ledger.record_commit(ct.doc_id, seq, ct.trace_ids,
                                              durable_ms, total_ms)
            if early and ft is not None:
                # a watch delivered this generation before the stamp
                for tid in early:
                    ft.record(tid, "watch_delivery", doc=ct.doc_id, seq=seq)

    @contextlib.contextmanager
    def audit_commit(self, ct: trace_mod.CommitTrace):
        """Around a single commit's own merge on the scheduler thread:
        when the commit is due a sample (``flight.audit_due``), run the
        block under the chain audit (thread-local: it counts this
        thread's ops only) and keep the summary for
        :meth:`record_commit`.  The audited merge is the commit's own —
        no second merge; the audit's dispatch cost lands in the block's
        stage (``merge``), the summary's assembly in ``audit_sample``.
        A commit whose merge raises keeps no sample."""
        ct.audit_sampled = True
        ct.audit_result = None
        if not self.flight.audit_due(ct.num_ops):
            yield
            return
        from ..utils import chainaudit
        with chainaudit.Audit() as a:
            yield
        try:
            with ct.stage("audit_sample"):
                ct.audit_result = a.result().summary()
        except Exception as e:   # noqa: BLE001 — tripwire sampling
            ct.audit_result = {"sample_error": repr(e)}

    def _audit_second_merge(self, ct: trace_mod.CommitTrace) -> Dict:
        """The sample of a commit whose merge was not audited in place
        (a grouped or remote round): a second merge of its fused batch
        on this engine's device, under the audit.  It runs on the
        scheduler thread and stalls every queued commit while it does,
        so it is billed as the visible ``audit_sample`` stage."""
        from ..utils import chainaudit
        try:
            with ct.stage("audit_sample"):
                return chainaudit.audit_packed_summary(ct.packed,
                                                       self.device)
        except Exception as e:   # noqa: BLE001 — tripwire sampling
            # a failed SAMPLE is not an audit failure: record the error
            # without an "ok" verdict (no dump trigger)
            return {"sample_error": repr(e)}

    def presample_audit(self, ct: trace_mod.CommitTrace) -> None:
        """Pipelined rounds sample the chain audit on the SCHEDULER
        thread at prepare time (never on the WAL-sync worker, never
        concurrently with the scheduler's launches); :meth:`record_commit`
        then uses the stored result."""
        if ct.audit_sampled:
            return
        ct.audit_sampled = True
        ct.audit_result = None
        if (ct.packed is not None and ct.outcome in
                ("committed", "partial")
                and self.flight.audit_due(ct.num_ops)):
            ct.audit_result = self._audit_second_merge(ct)

    # -- lifecycle / observability ---------------------------------------

    def scheduler_metrics(self) -> Dict:
        """Engine-wide scheduler counters + profiling spans
        (``GET /metrics/scheduler``)."""
        from ..utils import profiling
        out = dict(self.counters.snapshot())
        out["docs"] = len(self._docs)
        out["queue_depth_total"] = sum(
            len(d.queue) for d in self.docs())
        out["spans"] = profiling.span_stats("serve.")
        out["flight"] = self.flight.stats()
        # pipelined commit path + maintenance lane (serve/workers.py)
        out["pipeline"] = {
            "enabled": self.sync_worker is not None,
            **(self.sync_worker.stats()
               if self.sync_worker is not None else {}),
        }
        out["maintenance"] = None if self.maintenance is None \
            else self.maintenance.stats()
        # ops-axis sharded-merge routing (parallel/opsaxis.py)
        from ..parallel import opsaxis
        out["opsaxis"] = opsaxis.stats()
        # disaggregated merge tier (mergetier/): None when off — the
        # key's absence is the contract the prom renderer keys off
        out["mergetier"] = None if self.mergetier is None \
            else self.mergetier.stats()
        return out

    def render_prom(self) -> str:
        """The unified Prometheus-style exposition
        (``GET /metrics/prom``; obs/prom.py)."""
        from ..obs import prom
        return prom.render_engine(self)

    def debug_flight(self) -> Dict:
        """The enriched flight-recorder view (``GET /debug/flight``):
        recorder config + counters + the full commit-record ring."""
        return self.flight.debug_view()

    def flush(self, timeout: float = 60.0) -> bool:
        """Barrier: block until every ticket admitted BEFORE this call
        has resolved and its flight record has landed, WITHOUT closing
        the engine (the ``close()``-as-barrier / ``records_total``
        polling replacement — records land asynchronously after the
        ticket resolves, docs/OBSERVABILITY.md).  Returns False on
        timeout (e.g. a paused scheduler with pending work) and on a
        stopping or stopped scheduler (close() fails tickets without
        flight records, so the barrier cannot hold)."""
        return self.scheduler.flush(timeout=timeout)

    def close(self, timeout: float = 10.0) -> None:
        """Stop the scheduler and fail any unresolved tickets (503) —
        clean shutdown never leaves a handler thread blocked.  The
        documents' ephemeral spill tiers are deleted with the engine.
        Pipeline lanes stop IN ORDER: scheduler (no new rounds), then
        the WAL-sync worker (queued fsyncs drain — their acks must
        still resolve), then maintenance (abandons its queue:
        spill/fold/export work is idempotent and re-derivable)."""
        # wake every parked watcher FIRST (they answer 503 and release
        # their handler threads) — a watcher parked on a condition
        # variable is invisible to socket severance, so without this a
        # clean shutdown would stall up to a full park budget
        for d in self.docs():
            d.watch.close()
        if self.reactor is not None:
            # the registries' close commands are already queued on the
            # loops: draining writes every reactor-parked watcher its
            # named close (503 / event: closed) before the loops join
            self.reactor.stop(timeout=timeout)
        self.scheduler.shutdown(timeout=timeout)
        if self.sync_worker is not None:
            self.sync_worker.stop(timeout=timeout)
        if self.maintenance is not None:
            self.maintenance.stop(timeout=timeout)
        for d in self.docs():
            try:
                d.tree._log.close()
            except Exception:   # noqa: BLE001 — shutdown boundary
                pass
            if d.wal is not None:
                d.wal.close()
        if self.shared_wal is not None:
            self.shared_wal.close()
        if self.shmcache is not None:
            # drop every shared-segment claim this process holds; the
            # last claimant's release unlinks (serve/shmcache.py)
            self.shmcache.close()
        if self._own_oplog_dir:
            import shutil
            shutil.rmtree(self.oplog_dir, ignore_errors=True)
