"""The commit pipeline's background lanes: WAL-sync and tier
maintenance.

The serving scheduler used to be one thread doing everything in series:
merge compute, per-round group-commit fsync, snapshot publish, matz
export, WAL compaction, spill/fold.  Acked throughput was therefore
bounded by the SUM of compute and durability/maintenance latencies.
This module splits the round barrier into a two-stage pipeline plus a
maintenance lane (docs/DURABILITY.md §Pipelined commits):

- :class:`WalSyncWorker` — a dedicated thread owning the second half
  of every group commit: fsync, publish (a snapshot the scheduler
  PRE-DERIVED at compute time — immutable, pinned ``LogView``), ticket
  resolution, and the flight record.  The scheduler computes round
  N+1's fuse+merge while round N's fsync is in flight here, at
  pipeline depth 1 (the scheduler joins the previous job before
  queueing the next), so steady-state round time is
  ``max(compute, fsync)`` instead of their sum.  The ack contract is
  unchanged: **no ticket resolves and no snapshot publishes until its
  round's fsync completed**; a failed fsync hands every covered commit
  back to the scheduler, which ROLLS THE MERGE BACK (to the earliest
  doomed commit's pre-state — later rounds' commits on the same
  document are covered too, they causally sit on top) and sheds the
  tickets as honest 503s before anything from a later round can
  publish for those documents.  WAL records are ENCODED during
  compute but only APPENDED at the round barrier, strictly after the
  previous job resolved — so a failed fsync can never leave a later
  round's record describing ops the rollback destroyed.

- :class:`MaintenanceWorker` — a bounded work queue owning everything
  O(doc-state) that used to run between rounds on the scheduler
  thread: hot-tail spills past the budget, cold-segment folds +
  segment GC, shared-WAL stream compaction, and matz artifact exports
  (the scheduler snapshots the mirror arrays copy-on-export —
  ``TpuTree.matz_snapshot`` — so the worker can serialize while the
  scheduler keeps applying).  Background spills are EXTENT-CAPPED at
  the document's fsync-durable extent (``ServedDoc`` safe extent):
  the worker never seals rows a failed group fsync could still roll
  back.  Backpressure is explicit: when the worker lags and a hot
  tail breaches the hard cap (``GRAFT_OPLOG_HOT_HARD_MULT`` ×
  ``hot_ops``) the scheduler spills inline anyway
  (``inline_spill_fallbacks``), so resident memory stays bounded no
  matter what.  The worker's policy tick also implements the
  many-doc-fleet spill policies: ``GRAFT_OPLOG_HOT_AGE_S`` sweeps
  idle tails past an age, and ``GRAFT_OPLOG_RESIDENT_MB`` bounds the
  engine-wide hot-resident total by draining the LARGEST hot tails
  first.

Both workers touch no CUDA tensor: spills, folds, compactions, and
exports are numpy + file I/O, so only the scheduler thread launches on
the card.

Chaos: ``GRAFT_CRASH_POINT`` sites that used to fire on the scheduler
now legitimately fire on these threads; in in-process mode the
:class:`~crdt_graph_tpu_torch.wal.CrashPoint` marks the worker crashed and
the scheduler dies at its next loop check — the whole-process death
shape the kill matrix recovers from.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

from .. import wal as wal_mod
from ..utils.hostenv import env_int as _env_int
from .metrics import Histogram, LATENCY_BOUNDS_MS


class PendingCommit:
    """One document's deferred group commit riding the pipeline: the
    compute half is done (ops merged, attribution recorded, WAL
    records encoded, next snapshot derived); the durability half
    (append at the barrier, fsync, publish, resolve, record) is owed.
    ``saved`` is the pre-commit state the shed rollback needs."""

    __slots__ = ("doc", "tickets", "ct", "publish_needed", "saved",
                 "log_len", "records", "snap", "queued_t", "error",
                 "resolved")

    def __init__(self, doc, tickets, ct, publish_needed: bool = True):
        self.doc = doc
        self.tickets = tickets
        self.ct = ct
        self.publish_needed = publish_needed
        self.saved: Optional[tuple] = None
        self.log_len = 0
        self.records: List[bytes] = []
        self.snap = None
        self.queued_t = 0.0
        self.error: Optional[BaseException] = None
        self.resolved = False


class WalSyncWorker(threading.Thread):
    """The pipeline's fsync stage (module docstring), with a pluggable
    fan-out backend (``GRAFT_WAL_SYNC_BACKEND``; docs/DURABILITY.md
    §Sync backends):

    - ``single`` — the serialized baseline: one fsync at a time on
      this thread, entries resolve in queue order.  A round's ack p99
      is gated by the SUM of its docs' fsyncs.
    - ``workers`` — the portable fan-out: entries dispatch to a small
      thread pool, each doc's ``publish_prepared`` + ticket resolve
      runs the moment ITS file's fsync lands, not when the round's
      slowest file does.
    - ``uring`` — the completion-driven lane: this thread owns one
      io_uring (utils/uring.py) with many per-doc fsyncs in flight,
      reaping completions as the kernel posts them.  Zero extra
      threads; same per-completion resolve as ``workers``.
    - ``auto`` (default) — ``uring`` where the kernel supports it
      (probed once), else ``workers``.

    Every backend preserves the ack contract verbatim: nothing
    resolves or publishes until ITS doc's fsync completed; a failed
    fsync repairs the WAL tail and hands the doomed commits to the
    scheduler's rollback (``_fail`` — failure visible in
    ``_failed_sync`` BEFORE the doc's inflight count drops); the
    per-doc ``wait_docs_clear`` barrier means one document never has
    an append and an fsync in flight at once, which is exactly what
    makes the out-of-band ``Wal.sync_begin``/``sync_end`` split safe.
    Shared-stream engines (``GRAFT_WAL_SHARED``) pin ``single``: one
    stream has one fsync per round — there is nothing to fan out."""

    def __init__(self, engine, backend: Optional[str] = None):
        super().__init__(name="crdt-wal-sync", daemon=True)
        self.engine = engine
        self._cv = threading.Condition()
        self._q: collections.deque = collections.deque()
        # entries handed to a lane (single-loop iteration, pool, or
        # ring) and not yet finished/failed — the quiescence count
        # idle()/wait_idle/flush key off (replaces the old boolean
        # _executing: a fan-out lane can hold many at once)
        self._lane = 0
        self._stop_req = False
        self.crashed = False
        self._pool: Optional[_FsyncPool] = None
        self._ring = None
        self.backend_requested = backend if backend is not None \
            else wal_mod.sync_backend_from_env()
        if self.backend_requested not in wal_mod.SYNC_BACKENDS:
            raise ValueError(
                f"sync backend {self.backend_requested!r} not in "
                f"{wal_mod.SYNC_BACKENDS}")
        self.backend = self._resolve_backend(self.backend_requested)
        # telemetry (crdt_sched_pipeline_* / crdt_wal_sync_* families)
        self.jobs_done = 0
        self.commits_synced = 0
        self.commits_shed = 0

    def _resolve_backend(self, requested: str) -> str:
        if self.engine.shared_wal is not None:
            # one stream = one fsync per round; nothing to fan out
            return "single"
        if requested in ("auto", "uring"):
            from ..utils import uring as uring_mod
            if uring_mod.available():
                return "uring"
            if requested == "uring":
                # explicit ask the kernel can't honor: fall back,
                # counted — never silent (the stats pair
                # backend_requested/backend shows the downgrade too)
                self.engine.counters.add("wal_sync_uring_unavailable")
            return "workers"
        return requested

    # -- scheduler-side API ------------------------------------------------

    def submit(self, entries: List[PendingCommit]) -> None:
        """Queue one round's deferred commits.  Per-doc WAL files are
        independent streams, so the scheduler only serializes per
        DOCUMENT (:meth:`wait_docs_clear`) — entries from successive
        rounds flow through here continuously.  Shared-stream engines
        serialize globally instead (one fsync covers every queued
        record, and append order vs a failed fsync matters across the
        whole file)."""
        now = time.perf_counter()
        with self._cv:
            for e in entries:
                e.queued_t = now
                e.doc._sync_inflight += 1
                self._q.append(e)
            self._cv.notify_all()
        ring = self._ring
        if ring is not None:
            # the uring owner parks inside io_uring_enter, not on the
            # condition — bump its eventfd so the new entries dispatch
            # immediately instead of at the next completion
            ring.wake()

    def idle(self) -> bool:
        # under the condition: the run loop's pop→lane handoff is
        # atomic w.r.t. lock holders, but a lock-free read could land
        # in the gap and report quiescence over an executing batch —
        # matz pickup and flush() key real invariants off this
        with self._cv:
            return not (self._q or self._lane)

    @property
    def inflight(self) -> int:
        with self._cv:
            return len(self._q) + self._lane

    def sync_inflight(self) -> int:
        """Entries currently in the fan-out lane (dispatched, fsync
        not yet completed) — the ``crdt_wal_sync_inflight`` gauge."""
        with self._cv:
            return self._lane

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until no entry is queued or executing.  False on
        timeout or a crashed worker (the caller checks ``crashed``)."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._cv:
            while self._q or self._lane:
                if self.crashed:
                    return False
                remaining = 0.25 if deadline is None \
                    else deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(min(remaining, 0.25))
            return not self.crashed

    def wait_docs_clear(self, docs, timeout: Optional[float] = None
                        ) -> bool:
        """Block until none of ``docs`` has an entry in flight — the
        PER-DOC pipeline barrier: a document's next record may only
        append once its previous fsync resolved (failed-fsync tail
        drops must never orphan a later record), but OTHER documents'
        entries flow freely."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._cv:
            while any(d._sync_inflight for d in docs):
                if self.crashed:
                    return False
                remaining = 0.25 if deadline is None \
                    else deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(min(remaining, 0.25))
            return not self.crashed

    def stop(self, timeout: float = 10.0) -> None:
        """Drain queued jobs (their acks must still resolve), then
        exit."""
        with self._cv:
            self._stop_req = True
            self._cv.notify_all()
        ring = self._ring
        if ring is not None:
            ring.wake()
        if self.is_alive():
            self.join(timeout)

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            inflight = len(self._q) + self._lane
            lane = self._lane
        return {"jobs_done": self.jobs_done,
                "commits_synced": self.commits_synced,
                "commits_shed": self.commits_shed,
                "inflight": inflight,
                # sync-backend fan-out (docs/DURABILITY.md §Sync
                # backends): which lane is live, what was asked for,
                # and how many fsyncs it holds in flight right now
                "backend": self.backend,
                "backend_requested": self.backend_requested,
                "sync_inflight": lane,
                "crashed": self.crashed}

    # -- worker loop -------------------------------------------------------

    def run(self) -> None:
        try:
            if self.backend == "uring":
                from ..utils import uring as uring_mod
                try:
                    ring = uring_mod.FsyncRing(entries=_env_int(
                        "GRAFT_WAL_URING_ENTRIES", 256))
                except (uring_mod.UringUnavailable, OSError):
                    # the construction-time probe passed but setup
                    # failed now (fd limits, cgroup memlock): degrade
                    # to the portable lane, counted — never silent
                    self.backend = "workers"
                    self.engine.counters.add(
                        "wal_sync_uring_unavailable")
            if self.backend == "uring":
                self._ring = ring
                try:
                    self._run_uring(ring)
                finally:
                    self._ring = None
                    ring.close()
            else:
                if self.backend == "workers":
                    self._pool = _FsyncPool(self, max(1, min(
                        64, _env_int("GRAFT_WAL_SYNC_WORKERS", 8))))
                self._run_queue()
        except wal_mod.CrashPoint:
            # simulated kill (GRAFT_CRASH_POINT, in-process mode): die
            # like a SIGKILL — resolve nothing, clean up nothing; the
            # flag makes the scheduler die at its next loop check
            # (whole-process death shape).
            self._note_crash()
            return

    def _note_crash(self) -> None:
        """A lane thread hit a :class:`~crdt_graph_tpu_torch.wal.CrashPoint`
        — mark the whole pipeline dead exactly like the single-lane
        epilogue always did (crashed BEFORE any waiter wakes: no
        quiescence over a dead lane)."""
        self.crashed = True
        sched = self.engine.scheduler
        sched._sync_crashed = True
        with sched.cond:
            sched.cond.notify_all()
        with self._cv:
            self._cv.notify_all()

    # -- queue-driven lanes (single / workers / shared-stream) ------------

    def _run_queue(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stop_req \
                        and not self.crashed:
                    self._cv.wait(0.25)
                if self.crashed:
                    return          # a pool thread died on a crash
                    # site; _note_crash already ran its epilogue
                if not self._q:
                    break           # stop requested, drained
                # take everything queued: the single lane fsyncs and
                # resolves entry by entry (arrivals during the sweep
                # wait one turn); the workers lane dispatches each to
                # the pool; shared mode covers the whole batch with
                # its ONE stream fsync
                entries = list(self._q)
                self._q.clear()
                self._lane += len(entries)
            try:
                self._run_job(entries)
            except wal_mod.CrashPoint:
                # mark BEFORE the finally wakes waiters: a barrier
                # waiter woken by that notify must see the crash,
                # never quiescence over a dead lane
                self.crashed = True
                raise
            except Exception as e:  # noqa: BLE001 — thread boundary
                # a bug in the sync stage must not wedge the
                # pipeline: shed what the batch hadn't resolved
                # (the scheduler rolls back and resolves tickets)
                self._fail([x for x in entries
                            if not x.resolved], e)
            finally:
                with self._cv:
                    self._cv.notify_all()
        # stop path: pool entries may still be in flight — their acks
        # must resolve before the lane exits (engine.close contract)
        with self._cv:
            while self._lane and not self.crashed:
                self._cv.wait(0.25)
        if self._pool is not None:
            self._pool.stop()

    def _run_job(self, entries: List[PendingCommit]) -> None:
        if self.engine.shared_wal is not None:
            self._sync_shared(entries)
        elif self._pool is not None:
            for entry in entries:
                self._pool.submit(entry)
        else:
            for entry in entries:
                self._sync_one(entry)
        self.jobs_done += 1

    def _sync_one(self, entry: PendingCommit) -> None:
        """One entry's whole durability half, synchronously: crash
        sites, fsync, failure shed, finish.  The unit both the single
        lane (serially, on the worker thread) and the workers lane
        (concurrently, on pool threads) execute."""
        wal_mod.maybe_crash("ack-pre-fsync")
        t0 = time.perf_counter()
        try:
            entry.doc.wal.sync()
        except OSError as e:
            self._fail([entry], e)
            return
        ms = (time.perf_counter() - t0) * 1e3
        wal_mod.maybe_crash("post-fsync-pre-publish")
        self._finish(entry, ms, t0)

    # -- completion-driven lane (io_uring) --------------------------------

    def _run_uring(self, ring) -> None:
        """Ring-owner loop: drain the queue into in-flight fsync SQEs,
        park in ``io_uring_enter`` until completions (or a submit-side
        wakeup) land, resolve each doc THE MOMENT its own durability
        completed.  Crash sites fire per entry at dispatch
        (ack-pre-fsync) and per completion (post-fsync-pre-publish) —
        the same sites, same order per doc, as the serial lane."""
        pending: Dict[int, tuple] = {}
        token = 0
        while True:
            with self._cv:
                entries = list(self._q)
                self._q.clear()
                self._lane += len(entries)
                stop = self._stop_req
            for i, entry in enumerate(entries):
                if ring.inflight >= ring.max_inflight:
                    # ring at capacity: requeue the tail (front, in
                    # order) and reap before submitting more
                    with self._cv:
                        self._q.extendleft(reversed(entries[i:]))
                        self._lane -= len(entries) - i
                    entries = entries[:i]
                    break
                token += 1
                self._uring_dispatch(ring, entry, token, pending)
            if entries:
                self.jobs_done += 1     # one dispatch burst ≈ one job
            if not pending and stop:
                with self._cv:
                    if not self._q:
                        return      # drained: every ack resolved
                continue
            # block only when nothing was just dispatched — after a
            # dispatch burst, poll so a freshly queued round is not
            # stuck behind the oldest in-flight fsync
            for tok, res in ring.wait_completions(
                    block=not entries):
                self._uring_complete(tok, res, pending)

    def _uring_dispatch(self, ring, entry: PendingCommit, token: int,
                        pending: Dict[int, tuple]) -> None:
        wal_mod.maybe_crash("ack-pre-fsync")
        try:
            fd = entry.doc.wal.sync_begin()
        except OSError as e:
            self._fail([entry], e)
            return
        t0 = time.perf_counter()
        pending[token] = (entry, t0)
        try:
            ring.submit_fsync(fd, token)
        except OSError as e:
            # submission itself failed: same contract as a failed
            # fsync — repair the tail, shed the commit
            pending.pop(token, None)
            try:
                entry.doc.wal.sync_end(e.errno or 5, 0.0)
            except OSError as e2:
                self._fail([entry], e2)

    def _uring_complete(self, token: int, res: int,
                        pending: Dict[int, tuple]) -> None:
        entry, t0 = pending.pop(token)
        ms = (time.perf_counter() - t0) * 1e3
        try:
            entry.doc.wal.sync_end(-res if res < 0 else 0, ms)
        except OSError as e:
            self._fail([entry], e)
            return
        wal_mod.maybe_crash("post-fsync-pre-publish")
        self._finish(entry, ms, t0)

    def _sync_shared(self, entries: List[PendingCommit]) -> None:
        wal_mod.maybe_crash("ack-pre-fsync")
        shared = self.engine.shared_wal
        t0 = time.perf_counter()
        try:
            shared.sync(covered_docs=len(entries))
        except OSError as e:
            self._fail(entries, e)
            return
        ms = (time.perf_counter() - t0) * 1e3
        wal_mod.maybe_crash("post-fsync-pre-publish")
        self.engine.counters.add("wal_shared_rounds")
        self.engine.counters.add("wal_shared_covered_docs",
                                 len(entries))
        for entry in entries:
            self._finish(entry, ms, t0)

    def _finish(self, entry: PendingCommit, fsync_ms: float,
                t_sync_start: float) -> None:
        """One commit's post-fsync half: durable mark, publish the
        PRE-DERIVED snapshot, resolve tickets, record.  The
        ``wal_fsync`` stage is split: ``wal_fsync_queued`` is the
        pipeline wait (compute end → fsync start — the overlap the
        pipeline buys back is visible as this stage hiding under the
        next round's compute), ``wal_fsync`` the sync itself."""
        doc, ct = entry.doc, entry.ct
        doc.wal_mark_durable()
        queued_ms = max(0.0, (t_sync_start - entry.queued_t) * 1e3)
        ct.stages_ms["wal_fsync_queued"] = round(
            ct.stages_ms.get("wal_fsync_queued", 0.0) + queued_ms, 3)
        ct.stages_ms["wal_fsync"] = round(
            ct.stages_ms.get("wal_fsync", 0.0) + fsync_ms, 3)
        t1 = time.perf_counter()
        if entry.publish_needed:
            ct.staleness_s = doc.publish_prepared(entry.snap)
        ct.wal_deferred = False
        ct.total_ms = round(
            ct.total_ms + queued_ms + fsync_ms
            + (time.perf_counter() - t1) * 1e3, 3)
        self.engine.stamp_visibility(doc, ct, ct.total_ms)
        for t in entry.tickets:
            t.done.set()
        doc.commit_ms.observe(ct.total_ms)
        self.engine.record_commit(doc, ct)
        doc.note_durable(entry.log_len)
        # the safe extent just advanced: a spill task that was capped
        # at the OLD extent may have left the tail over budget —
        # re-arm it (enqueue coalesces with an already-queued task)
        maint = self.engine.maintenance
        if maint is not None and doc.tree._log.tiering_enabled \
                and doc.tree._log.spill_due():
            maint.enqueue("spill", doc)
        entry.resolved = True
        with self._cv:
            doc._sync_inflight -= 1
            self._lane -= 1
            self.commits_synced += 1   # under the cv: pool threads
            # finish concurrently and += is not atomic across threads
            self._cv.notify_all()

    def _fail(self, entries: List[PendingCommit], e: Exception) -> None:
        """Hand doomed commits back to the scheduler: only the tree's
        owner may roll the merges back, and the tickets resolve AFTER
        the rollback so a client's error response never races a log
        still holding its shed ops."""
        for entry in entries:
            entry.error = e
            entry.resolved = True
        # order matters: the failure must be VISIBLE to the scheduler
        # (in _failed_sync) before the doc's inflight count drops —
        # a barrier waiter released by the decrement runs
        # _service_failures immediately and must find these entries,
        # or it would append the doc's next record on top of the
        # doomed, about-to-be-rolled-back ops
        sched = self.engine.scheduler
        with sched.cond:
            sched._failed_sync.extend(entries)
            sched.cond.notify_all()
        with self._cv:
            for entry in entries:
                entry.doc._sync_inflight -= 1
            self._lane -= len(entries)
            self.commits_shed += len(entries)
            self._cv.notify_all()
        if sched.stopped:
            # a stopping scheduler will never service these — resolve
            # the tickets now (no rollback possible; the engine is
            # closing) so no handler thread blocks through close()
            sched.abandon_failed_sync()


class _FsyncPool:
    """The ``workers`` sync backend's thread pool: a shared FIFO of
    :class:`PendingCommit` entries, each executed by
    :meth:`WalSyncWorker._sync_one` on whichever pool thread picks it
    up — so every document's publish + resolve happens the moment ITS
    fsync lands.  Per-doc safety needs no pool-side ordering: the
    scheduler's ``wait_docs_clear`` barrier guarantees at most one
    entry per document is in flight anywhere in the lane."""

    def __init__(self, worker: WalSyncWorker, n_threads: int):
        self.worker = worker
        self._cv = threading.Condition()
        self._q: collections.deque = collections.deque()
        self._stop = False
        self._threads = [
            threading.Thread(target=self._run,
                             name=f"crdt-wal-sync-{i}", daemon=True)
            for i in range(n_threads)]
        for t in self._threads:
            t.start()

    def submit(self, entry: PendingCommit) -> None:
        with self._cv:
            self._q.append(entry)
            self._cv.notify()

    def stop(self, timeout: float = 10.0) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))

    def _run(self) -> None:
        w = self.worker
        while True:
            with self._cv:
                while not self._q and not self._stop \
                        and not w.crashed:
                    self._cv.wait(0.25)
                if w.crashed:
                    return      # simulated process death: abandon
                    # the rest, exactly like the serial lane does
                if not self._q:
                    return      # stop requested and drained
                entry = self._q.popleft()
            try:
                w._sync_one(entry)
            except wal_mod.CrashPoint:
                # a crash site fired on this pool thread: same
                # whole-process-death shape as the serial lane
                w._note_crash()
                return
            except Exception as e:  # noqa: BLE001 — thread boundary
                if not entry.resolved:
                    w._fail([entry], e)


class MaintenanceWorker(threading.Thread):
    """The tier-maintenance lane (module docstring): a bounded FIFO of
    ``(kind, doc, payload)`` tasks — ``spill`` (which runs fold/GC +
    tomb sweeping behind the seal) / ``compact`` / ``matz`` /
    ``scrub`` (the checksum sweep + peer repair of
    docs/DURABILITY.md §Scrub & repair, on the
    ``GRAFT_SCRUB_INTERVAL_S`` cadence) — plus a periodic policy tick
    implementing the age and engine-wide resident-bytes spill
    policies."""

    POLL_S = 0.5

    def __init__(self, engine, max_queue: int = 256):
        super().__init__(name="crdt-maintenance", daemon=True)
        self.engine = engine
        self.max_queue = max_queue
        self._cv = threading.Condition()
        self._q: collections.deque = collections.deque()
        self._queued_keys: set = set()
        self._executing = False
        self._stop_req = False
        self.crashed = False
        # telemetry (crdt_maint_* prom families; loadgen report)
        self.tasks_done: Dict[str, int] = {}
        self.task_errors = 0
        self.queue_full_drops = 0
        self.inline_spill_fallbacks = 0
        self.policy_age_spills = 0
        self.policy_resident_spills = 0
        self.scrubs_queued = 0
        self.task_ms = Histogram(LATENCY_BOUNDS_MS)
        self.matz_export_ms = Histogram(LATENCY_BOUNDS_MS)

    # -- producer API ------------------------------------------------------

    def enqueue(self, kind: str, doc=None, payload=None) -> bool:
        """Queue one task; coalesces with an identical queued task
        (same kind + document).  Spill tasks coalesce even with a
        payload — the policy tick fires every POLL_S and must not
        stack duplicate sweeps behind a slow task (the first queued
        request wins; a later tick re-enqueues once it ran).  False
        when the bounded queue is full (counted — the inline hard-cap
        fallback keeps memory bounded regardless)."""
        key = (kind, id(doc) if doc is not None else 0)
        coalesce = payload is None or kind == "spill"
        with self._cv:
            if coalesce and key in self._queued_keys:
                return True                 # already queued; coalesce
            if len(self._q) >= self.max_queue:
                self.queue_full_drops += 1
                return False
            self._q.append((kind, doc, payload))
            if coalesce:
                self._queued_keys.add(key)
            self._cv.notify_all()
            return True

    def note_inline_spill(self) -> None:
        """The scheduler spilled inline past the hard cap (this worker
        was lagging) — the bounded-memory fallback, counted."""
        self.inline_spill_fallbacks += 1

    def idle(self) -> bool:
        with self._cv:     # same pop→executing gap rule as WalSyncWorker
            return not (self._q or self._executing)

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._q) + (1 if self._executing else 0)

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._cv:
            while self._q or self._executing:
                if self.crashed:
                    return False
                remaining = 0.25 if deadline is None \
                    else deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(min(remaining, 0.25))
            return not self.crashed

    def stop(self, timeout: float = 10.0) -> None:
        with self._cv:
            self._stop_req = True
            self._cv.notify_all()
        if self.is_alive():
            self.join(timeout)

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            depth = len(self._q) + (1 if self._executing else 0)
        return {"queue_depth": depth,
                "tasks_done": dict(self.tasks_done),
                "task_errors": self.task_errors,
                "queue_full_drops": self.queue_full_drops,
                "inline_spill_fallbacks": self.inline_spill_fallbacks,
                "policy_age_spills": self.policy_age_spills,
                "policy_resident_spills": self.policy_resident_spills,
                "scrubs_queued": self.scrubs_queued,
                "task_ms": self.task_ms.export(),
                "matz_export_ms": self.matz_export_ms.export(),
                "crashed": self.crashed}

    # -- worker loop -------------------------------------------------------

    def run(self) -> None:
        try:
            last_policy = time.monotonic()
            while True:
                with self._cv:
                    while not self._q and not self._stop_req \
                            and time.monotonic() - last_policy \
                            < self.POLL_S:
                        self._cv.wait(self.POLL_S)
                    if self._stop_req:
                        break               # abandon queued work:
                        # maintenance is idempotent and re-derivable
                    task = None
                    if self._q:
                        task = self._q.popleft()
                        kind, doc, _ = task
                        if task[2] is None or kind == "spill":
                            self._queued_keys.discard(
                                (kind, id(doc) if doc is not None
                                 else 0))
                        self._executing = True
                if task is None:
                    self._policy_tick()
                    last_policy = time.monotonic()
                    continue
                t0 = time.perf_counter()
                try:
                    self._execute(*task)
                except wal_mod.CrashPoint:
                    # mark BEFORE the finally wakes waiters (same
                    # no-quiescence-over-a-dead-lane rule as the
                    # WAL-sync worker)
                    self.crashed = True
                    raise
                except Exception:   # noqa: BLE001 — thread boundary:
                    # maintenance is an accelerator; a failed task
                    # (disk full mid-seal) is counted, never fatal
                    self.task_errors += 1
                else:
                    # completions only — errored tasks are counted in
                    # task_errors, never double-booked as done
                    self.tasks_done[task[0]] = \
                        self.tasks_done.get(task[0], 0) + 1
                finally:
                    self.task_ms.observe(
                        (time.perf_counter() - t0) * 1e3)
                    with self._cv:
                        self._executing = False
                        self._cv.notify_all()
        except wal_mod.CrashPoint:
            # simulated kill — same shape as WalSyncWorker.run
            sched = self.engine.scheduler
            sched._sync_crashed = True
            with sched.cond:
                sched.cond.notify_all()
            with self._cv:
                self._cv.notify_all()
            return

    def _execute(self, kind: str, doc, payload) -> None:
        if kind == "spill":
            # spill_to runs the fold/GC + tomb sweep behind the seal,
            # exactly like the inline commit-boundary path did — there
            # is deliberately no separate gc task kind
            keep_hot = (payload or {}).get("keep_hot")
            doc.tree._log.spill_to(doc.safe_extent(), keep_hot=keep_hot)
        elif kind == "matz":
            t0 = time.perf_counter()
            try:
                doc.tree.export_matz(payload)
            finally:
                self.matz_export_ms.observe(
                    (time.perf_counter() - t0) * 1e3)
        elif kind == "compact":
            if self.engine.shared_wal is not None:
                self.engine.shared_wal.compact()
        elif kind == "scrub":
            # checksum sweep + quarantine + peer repair — numpy/file/
            # HTTP I/O only, same no-CUDA lane contract as the rest
            doc.run_scrub()
        elif kind == "wire":
            # zero-copy egress sidecar build (oplog.py; docs/SERVING.md
            # §Zero-copy egress): one unpack+encode per SEALED segment,
            # queued by the first cold window that wanted it — pure
            # file I/O + JSON encode, off the request threads
            from .. import oplog as oplog_mod
            sf = self.engine.sendfile_stats
            ok = oplog_mod.ensure_wire_sidecar(payload)
            if sf is not None:
                sf.add("sidecar_builds" if ok
                       else "sidecar_build_failures")
        elif kind == "shmrel":
            # publish-swap retirement of an outgoing generation's
            # shared-segment claim (serve/shmcache.py): manifest flock
            # I/O, deliberately off the publish/scheduler threads
            shm = self.engine.shmcache
            if shm is not None:
                shm.release(payload)

    # -- spill policies -------------------------------

    def _policy_tick(self) -> None:
        """Size/age spill policy for many-doc fleets: sweep hot tails
        past ``GRAFT_OPLOG_HOT_AGE_S``, and when the engine-wide
        hot-resident total exceeds ``GRAFT_OPLOG_RESIDENT_MB``, drain
        the LARGEST hot tails first until the projection fits.  Also
        queues each tiered doc's checksum scrub on the
        ``GRAFT_SCRUB_INTERVAL_S`` cadence."""
        eng = self.engine
        self._scrub_tick()
        age = eng.oplog_hot_age_s
        budget = eng.oplog_resident_bytes
        if age <= 0 and budget <= 0:
            return
        docs = [d for d in eng.docs()
                if d.tree._log.tiering_enabled]
        if age > 0:
            for d in docs:
                log = d.tree._log
                if log.hot_len and log.hot_age_s() >= age \
                        and d.safe_extent() > log.tiered_extent:
                    if self.enqueue("spill", d, {"keep_hot": 0}):
                        self.policy_age_spills += 1
        if budget > 0:
            pairs = sorted(
                ((d.tree._log.hot_bytes(), d) for d in docs),
                key=lambda p: p[0], reverse=True)
            total = sum(b for b, _ in pairs)
            for b, d in pairs:
                if total <= budget or b <= 0:
                    break
                if d.safe_extent() <= d.tree._log.tiered_extent:
                    continue
                if self.enqueue("spill", d, {"keep_hot": 0}):
                    self.policy_resident_spills += 1
                    total -= b

    def _scrub_tick(self) -> None:
        """Queue a scrub for every tiered doc whose last sweep is
        older than the cadence (docs/DURABILITY.md §Scrub & repair).
        The stamp advances at ENQUEUE so a slow sweep never stacks
        duplicates behind itself (enqueue coalesces anyway)."""
        interval = self.engine.scrub_interval_s
        if interval <= 0:
            return
        now = time.monotonic()
        for d in self.engine.docs():
            if not d.tree._log.tiering_enabled:
                continue
            if now - d._last_scrub >= interval:
                if self.enqueue("scrub", d):
                    d._last_scrub = now
                    self.scrubs_queued += 1
