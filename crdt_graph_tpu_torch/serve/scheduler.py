"""The coalescing merge scheduler: one thread drains every document's
write queue into fused kernel launches.

Scheduling policy, per round:

1. **Collect** — under the scheduler condition, drain each non-empty
   document queue FIFO (one coalesced round per document; arrivals during
   processing wait for the next round — no starvation, bounded latency).
2. **Fuse** — concatenate each document's pending deltas into ONE packed
   batch (``codec.packed.concat_many``: one allocation, hints
   cross-resolved, vouched provenance preserved), remembering each
   ticket's row span for per-request attribution.
3. **Route** — fused batches above the engine's kernel crossover go to
   the batched kernel; when ≥2 documents route to the kernel in the same
   round (and each fits one chunk), the replica engine merges them in
   one call (``engine.apply_packed_grouped``): their candidate sets are
   padded to a shared capacity and materialized as ONE batched merge on
   the card (parallel.mesh.batched_materialize: one chain of dispatches
   over a leading document axis), each document committed from its
   slice of the batched table at the shared capacity.  Everything
   else merges per-document, with giant pushes split into bounded chunks
   (``engine.apply_packed_chunked``) so p50 commit latency is set by the
   chunk size, not the largest client.
4. **Attribute** — the engine's per-leaf applied mask, sliced by ticket
   span, gives each request its applied count / dup count / echo without
   materializing objects.  A fused batch that REJECTS (causality gap in
   some delta) is retried sequentially per ticket so only the guilty
   request 409s.
5. **Publish, then resolve** — if anything applied, derive and swap the
   document's read snapshot; only then are tickets resolved, so a
   client's follow-up read sees its write.

The scheduler thread is the only thread that touches live trees or
launches on the card of this engine.  With a merge-tier client armed
(mergetier/), every grouped run and every giant single ships to a
pooled merge worker instead (``_process_remote``); each verified frame
commits through the same ``finish_packed`` as a local grouped merge,
and any failure merges that document locally, on this engine's device.
Any non-CRDT exception while processing a document is recorded on that
document's tickets (handlers answer 500) and counted — the scheduler
itself stays up.
"""
from __future__ import annotations

import functools
import sys
import threading
import time
import traceback
from typing import List, Optional, Tuple

import numpy as np

from .. import wal as wal_mod
from ..codec import packed as packed_mod
from ..core.errors import CRDTError
from ..obs import fleettrace as fleettrace_mod
from ..obs.trace import CommitTrace
from ..utils import profiling
from .queue import (SchedulerError, SchedulerStopped, WalUnavailable,
                    WriteTicket)
from .workers import PendingCommit

# sentinel: _wal_shed's saved-state default ("use doc._commit_saved")
_SAVED_UNSET = object()

# one work item: (doc, tickets, fused_batch_or_None, ticket_row_spans,
# commit_trace) — the CommitTrace collects the per-stage breakdown and
# member trace_ids for the commit's flight record (obs/trace.py)
_WorkItem = Tuple["ServedDoc", List[WriteTicket],
                  Optional[packed_mod.PackedOps], List[Tuple[int, int]],
                  CommitTrace]


def _commit_ms(ct: CommitTrace) -> float:
    """A commit's total so far: its time on the scheduler thread since
    ``_guarded`` started it, plus a grouped round's shared prepare and
    batched launch (or a remote merge), which ran BEFORE it (stamped
    into ``stages_ms`` by ``_process_grouped``): billed into the commit
    total, or the SLO tripwire would be blind to the dominant device
    step of exactly these commits."""
    return (time.perf_counter() - ct.t_start) * 1e3 \
        + ct.stages_ms.get("batch_prepare", 0.0) \
        + ct.stages_ms.get("batched_launch", 0.0) \
        + ct.stages_ms.get("remote_merge", 0.0)


class MergeScheduler(threading.Thread):
    """Single scheduler thread over a :class:`ServingEngine`'s queues."""

    def __init__(self, engine, poll_s: float = 0.25):
        super().__init__(name="crdt-merge-scheduler", daemon=True)
        self.engine = engine
        self.cond = threading.Condition()
        self.poll_s = poll_s
        self._stop_requested = False
        self._paused = 0
        # True while a drained round is being processed off-lock: the
        # flush() barrier must not report quiescence between drain and
        # the round's last flight record
        self._busy = False
        self._rounds_completed = 0
        # group commit (wal.py; docs/DURABILITY.md): commits whose WAL
        # records were appended (serialized mode) or encoded
        # (pipelined mode) but not yet fsynced this round — publish,
        # ticket resolution, and the flight record wait for the
        # round's fsync.  Scheduler thread only.
        self._wal_round: List[PendingCommit] = []
        # pipelined commits a failed (or wiped) fsync handed back: the
        # scheduler rolls their merges back and resolves their tickets
        # at the next safe point (serve/workers.py WalSyncWorker._fail;
        # guarded by self.cond)
        self._failed_sync: List[PendingCommit] = []
        # set by a worker that died at a GRAFT_CRASH_POINT site: the
        # scheduler dies at its next loop check (in-process kill
        # simulation — a real SIGKILL takes every thread at once)
        self._sync_crashed = False
        # True while step() runs a round in the calling thread: the
        # round finishes inline (fsync included) regardless of the
        # pipeline knob, so staged deterministic tests stay exact
        self._round_inline = False

    # -- lifecycle --------------------------------------------------------

    @property
    def stopped(self) -> bool:
        return self._stop_requested

    def shutdown(self, timeout: float = 10.0) -> None:
        with self.cond:
            self._stop_requested = True
            self.cond.notify_all()
        if self.is_alive():
            self.join(timeout)
        # fail anything still queued (including tickets enqueued into a
        # never-started scheduler) so no handler thread blocks forever
        self._fail_pending(SchedulerStopped("serving engine shut down"))
        # ... and resolve any commits a failed fsync handed back that
        # the (now dead) loop will never roll back — their clients get
        # the honest 503, not a submit-timeout hang
        self.abandon_failed_sync()

    def _resolve_shed(self, entry) -> None:
        """Resolve one doomed deferred commit as the honest 503 and
        record it — the one shed shape both the loop path
        (_service_failures, post-rollback) and the shutdown path
        (abandon_failed_sync, no rollback possible) share."""
        err = WalUnavailable(
            f"write-ahead log unavailable for "
            f"{entry.doc.doc_id!r}: {entry.error!r}")
        err.__cause__ = entry.error
        for t in entry.tickets:
            if not t.done.is_set():
                t.error = err
                t.done.set()
        entry.ct.outcome = "error"
        entry.ct.error = f"wal: {entry.error!r}"
        entry.ct.wal_deferred = False
        self.engine.record_commit(entry.doc, entry.ct)

    def abandon_failed_sync(self) -> None:
        """Resolve handed-back failed-fsync commits WITHOUT a rollback
        (the scheduler is stopping or stopped — the tree has no owner
        left to roll it back, and the engine is closing).  Safe to
        call from any thread; idempotent."""
        with self.cond:
            failed, self._failed_sync = list(self._failed_sync), []
        for entry in failed:
            self._resolve_shed(entry)

    def pause(self) -> None:
        """Suspend draining (tests: stage a multi-doc round, then
        :meth:`step` it deterministically)."""
        with self.cond:
            self._paused += 1

    def resume(self) -> None:
        with self.cond:
            self._paused = max(0, self._paused - 1)
            self.cond.notify_all()

    # -- main loop --------------------------------------------------------

    def run(self) -> None:
        try:
            self._run()
        except wal_mod.CrashPoint:
            # simulated kill (GRAFT_CRASH_POINT, in-process mode):
            # die exactly like a SIGKILL would — resolve nothing,
            # fail nothing, clean up nothing.  The chaos harness
            # abandons this engine and recovers from disk.
            return

    def _run(self) -> None:
        while True:
            with self.cond:
                while not self._stop_requested \
                        and not self._sync_crashed \
                        and (self._paused or not self._work_due()):
                    self.cond.wait(self.poll_s)
                if self._stop_requested:
                    break
                if self._sync_crashed:
                    # a worker died at a crash site: the whole process
                    # is "dead" — stop exactly like the worker did
                    raise wal_mod.CrashPoint("pipeline worker died")
                drained = [] if self._paused else self._drain_locked()
                # deferred pipeline duties count as BUSY too: flush()
                # must not report quiescence while a failed-fsync
                # rollback or a matz pickup is mid-flight (the due
                # flag clears before its task lands on the queue)
                self._busy = bool(drained or self._failed_sync
                                  or self._work_due())
            if not drained:
                # no round to run, but deferred pipeline duties may be
                # due: rollbacks a failed fsync handed back, and matz
                # refreshes that may only cover fsync-durable ops
                # (sync lane idle)
                try:
                    self._service_failures()
                    self._pickup_matz()
                finally:
                    with self.cond:
                        self._busy = False
                        self.cond.notify_all()
                continue
            # a failure ANYWHERE in the round (fusion allocation,
            # grouping logic) must resolve the already-drained
            # tickets — they are in no queue, so nothing else can —
            # and must not kill the scheduler thread
            try:
                pending = self._process(self._fuse_all(drained))
                if pending:
                    self._barrier_and_submit(pending)
                elif self.engine.sync_worker is not None:
                    # rounds with nothing to fsync still service any
                    # handed-back failures promptly
                    self._service_failures()
            except Exception as e:  # noqa: BLE001 — thread boundary
                self.engine.counters.add("scheduler_errors")
                traceback.print_exc(file=sys.stderr)
                err = SchedulerError(f"merge round failed: {e!r}")
                err.__cause__ = e
                for doc, tickets in drained:
                    pending_t = [t for t in tickets
                                 if not t.done.is_set()]
                    for t in pending_t:
                        t.error = err
                        t.done.set()
                    if pending_t:
                        # the round died before (or while) this
                        # document's commit — leave an error record
                        # behind for the post-mortem dump
                        ct = CommitTrace(doc.doc_id, pending_t)
                        ct.outcome = "error"
                        ct.error = repr(e)
                        self.engine.record_commit(doc, ct)
            finally:
                with self.cond:
                    self._busy = False
                    self._rounds_completed += 1
                    self.cond.notify_all()
        with self.cond:
            self._busy = False
            self.cond.notify_all()
        self._fail_pending(SchedulerStopped("serving engine shut down"))
        self.abandon_failed_sync()

    def step(self) -> int:
        """Run exactly one scheduling round in the CALLING thread and
        return the number of documents processed.  Only valid while the
        scheduler thread is paused or not started (single-writer
        invariant on the trees).  Always runs the round SERIALIZED —
        fsync, publish, and resolution finish inline before this
        returns, pipeline or not (staged deterministic tests stay
        exact)."""
        with self.cond:
            drained = self._drain_locked()
            self._busy = bool(drained)
        self._round_inline = True
        try:
            if drained:
                self._process(self._fuse_all(drained))
        finally:
            self._round_inline = False
            # the flush() barrier must see a step()-driven round too
            with self.cond:
                self._busy = False
                self.cond.notify_all()
        return len(drained)

    def _has_work(self) -> bool:
        return any(len(d.queue) for d in self.engine.docs())

    def _work_due(self) -> bool:
        """Anything the loop owes a wake-up for: queued tickets,
        failed-fsync rollbacks, or a due matz refresh whose sync lane
        is idle (the artifact may only cover fsync-durable ops)."""
        if self._has_work() or self._failed_sync:
            return True
        if self.engine.maintenance is not None:
            sync = self.engine.sync_worker
            if sync is None or sync.idle():
                return any(d._matz_due for d in self.engine.docs())
        return False

    def _pipeline_active(self) -> bool:
        """Whether THIS round's group commit rides the two-stage
        pipeline: a WAL-sync worker exists (durable engine, batch
        mode) and the round is loop-driven
        (step() rounds finish inline)."""
        return (self.engine.sync_worker is not None
                and not self._round_inline)

    def flush(self, timeout: float = 60.0) -> bool:
        """Join the scheduler up to the current queue state WITHOUT
        stopping it: block until no queue holds a ticket admitted
        before this call, no drained round is still processing, every
        queued fsync has resolved (WAL-sync worker idle), and the
        maintenance queue is drained.  When this returns True every
        such ticket has resolved and its flight record has been
        recorded — AND the pipeline's deferred work is done, not just
        the tickets (the flush()/shutdown() race contract,
        docs/DURABILITY.md §Pipelined commits).  Returns False on
        timeout (e.g. the scheduler is paused or wedged with work
        still pending) or a crashed worker."""
        deadline = time.monotonic() + timeout
        while True:
            with self.cond:
                while True:
                    if self._stop_requested:
                        # a stopping (or stopped) scheduler fails
                        # pending tickets WITHOUT flight records — the
                        # barrier's guarantee cannot hold, so never
                        # report it does (even after _fail_pending has
                        # drained the queues)
                        return False
                    if self._sync_crashed:
                        return False
                    if not (self._busy or self._work_due()):
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    self.cond.wait(min(remaining, self.poll_s))
            # the scheduler is quiet; now barrier the pipeline lanes
            sync = self.engine.sync_worker
            maint = self.engine.maintenance
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            if sync is not None and not sync.wait_idle(remaining):
                return False
            remaining = deadline - time.monotonic()
            if maint is not None and (
                    remaining <= 0 or not maint.wait_idle(remaining)):
                return False
            # a sync completion may have woken the scheduler again
            # (failure hand-back, matz pickup): only report the
            # barrier held if everything is STILL quiet together
            with self.cond:
                quiet = not (self._busy or self._work_due()
                             or self._stop_requested
                             or self._sync_crashed)
            if quiet and (sync is None or sync.idle()) \
                    and (maint is None or maint.idle()):
                return True
            if time.monotonic() >= deadline:
                return False

    def _fail_pending(self, err: BaseException) -> None:
        with self.cond:
            leftovers = [(d, d.queue.drain())
                         for d in self.engine.docs() if len(d.queue)]
        for _, tickets in leftovers:
            for t in tickets:
                t.error = err
                t.done.set()

    # -- one round --------------------------------------------------------

    def _drain_locked(self) -> List[tuple]:
        """Pop every pending queue FIFO (requires ``self.cond``).  Only
        the O(1) deque drains happen under the condition — fusion's
        column copying runs AFTER release, so writers' admission path
        (offer or 429) never blocks behind a round's concatenation."""
        return [(doc, doc.queue.drain())
                for doc in self.engine.docs() if len(doc.queue)]

    def _fuse_all(self, drained: List[tuple]) -> List[_WorkItem]:
        """Fuse each document's drained deltas into one packed batch
        (scheduler thread, no locks held)."""
        work: List[_WorkItem] = []
        for doc, tickets in drained:
            doc.coalesce_width.observe(len(tickets))
            ct = CommitTrace(doc.doc_id, tickets)
            spans: List[Tuple[int, int]] = []
            parts = []
            base = 0
            for t in tickets:
                spans.append((base, base + t.n_leaves))
                base += t.n_leaves
                if t.n_leaves:
                    parts.append(t.packed)
            with ct.stage("fuse"):
                fused = packed_mod.concat_many(parts) if parts else None
            ct.packed = fused
            if len(parts) > 1:
                self.engine.counters.add("fused_batches")
                self.engine.counters.add("fused_tickets", len(tickets))
            work.append((doc, tickets, fused, spans, ct))
        return work

    def _process(self, work: List[_WorkItem]) -> List[PendingCommit]:
        self._wal_round = []
        singles: List[_WorkItem] = []
        groups: dict = {}
        for item in work:
            doc, tickets, fused, spans, ct = item
            if fused is None:      # only empty deltas this round
                for t in tickets:
                    self.engine.finish_ticket(doc, t,
                                              np.zeros(0, dtype=bool))
                    t.done.set()
                ct.outcome = "noop"
                self.engine.record_commit(doc, ct)
                continue
            # cross-doc grouping wants one launch per round: batches
            # that route to the kernel AND fit a single chunk — keyed by
            # CANDIDATE (log ∪ delta) bucket so a big-log document never
            # pads small co-grouped documents up to its own capacity
            # (equal buckets = zero padding waste)
            if (self.engine.cross_doc
                    and doc.tree.packed_route(fused.num_ops)
                    and fused.num_ops <= self.engine.chunk_ops):
                cand = packed_mod._bucket(
                    max(1, doc.tree.log_length + fused.num_ops))
                groups.setdefault(cand, []).append(item)
            else:
                singles.append(item)
        grouped_runs = []
        for items in groups.values():
            if len(items) >= 2:
                grouped_runs.append(items)
            else:
                singles.extend(items)
        # disaggregated merge tier (mergetier/, docs/MERGETIER.md):
        # with a client armed, coalescible rounds (every grouped run —
        # the worker coalesces them with the whole FLEET's traffic, so
        # same-bucket grouping is no longer a constraint) and giant
        # singles (>= GRAFT_MERGETIER_MIN_OPS) ship remote; any
        # failure falls back per-document to the bit-identical local
        # merge below
        remote_items: List[_WorkItem] = []
        if self.engine.mergetier is not None:
            from ..mergetier import client as mtclient_mod
            min_ops = mtclient_mod.route_min_ops()
            kept = []
            for item in singles:
                doc, _, fused, _, _ = item
                if doc.tree.packed_route(fused.num_ops) \
                        and fused.num_ops >= min_ops:
                    remote_items.append(item)
                else:
                    kept.append(item)
            singles = kept
            for items in grouped_runs:
                remote_items.extend(items)
            grouped_runs = []
        for item in singles:
            self._guarded(self._commit_single, item)
        for items in grouped_runs:
            self._process_grouped(items)
        if remote_items:
            self._process_remote(remote_items)
        if not self._pipeline_active():
            self._finish_wal_round()
            # persisted-materialization refresh LAST: every ticket
            # above has resolved, so the O(document) artifact export
            # (spill-all + mirror dump, ServedDoc.maybe_write_matz)
            # never sits between a client and its ack — it only delays
            # the next round's drain, bounded by GRAFT_MATZ_TAIL_OPS
            for item in work:
                try:
                    item[0].maybe_write_matz()
                except Exception:   # noqa: BLE001 — the artifact is an
                    # accelerator; a failed export (disk full mid-dump)
                    # must not take down the round loop.  CrashPoint is
                    # a BaseException and still propagates (chaos).
                    self.engine.counters.add("matz_write_errors")
            return []
        # pipelined: the compute half is done.  Pre-derive each
        # deferred commit's snapshot NOW (immutable, pinned LogView —
        # the worker's publish is then a pointer swap that cannot race
        # the next round's merges) and presample the chain audit on
        # this thread (never concurrently with kernel launches).  The caller joins the previous round's
        # fsync job, lands the encoded records, and queues these.
        pending, self._wal_round = self._wal_round, []
        for entry in pending:
            t0 = time.perf_counter()
            with entry.ct.stage("publish"):
                entry.snap = entry.doc.prepare_publish()
            # the derive is client-visible latency (the ack waits on
            # this commit's fsync, which waits on the queue behind it)
            entry.ct.total_ms += (time.perf_counter() - t0) * 1e3
            self.engine.presample_audit(entry.ct)
        return pending

    def _guarded(self, fn, item: _WorkItem, *args) -> None:
        """Run one document's commit; a non-CRDT failure is recorded on
        its tickets (handlers answer 500) — the scheduler survives.
        Either way the commit's trace lands in the flight recorder
        (an ``error`` outcome is one of its dump triggers)."""
        doc, tickets, ct = item[0], item[1], item[4]
        doc._round_records = []     # pipelined-round encode buffer
        ct.t_start = time.perf_counter()
        try:
            fn(item, *args)
        except Exception as e:   # noqa: BLE001 — thread boundary: the
            # error is re-raised in every waiting handler, not swallowed
            self.engine.counters.add("scheduler_errors")
            traceback.print_exc(file=sys.stderr)
            err = SchedulerError(f"commit failed: {e!r}")
            err.__cause__ = e
            for t in tickets:
                if not t.done.is_set():
                    t.error = err
                    t.done.set()
            ct.outcome = "error"
            ct.error = repr(e)
            # bill a grouped round's shared prepare+launch here too —
            # an errored member of the slowest rounds must not
            # under-report the dominant device step to the SLO tripwire
            ct.total_ms = _commit_ms(ct)
            self.engine.record_commit(doc, ct)
            return
        total_ms = _commit_ms(ct)
        ct.total_ms = total_ms
        if ct.wal_deferred:
            # group commit: the round barrier fsyncs, publishes,
            # resolves, and records — the total keeps accruing there
            return
        # the commit fully resolved on this thread (wal off, commit
        # mode, or a shed): no failed group fsync can roll it back, so
        # the background maintenance worker may spill through it
        doc.note_durable(doc.tree.log_length, matz_check=False)
        # re-arm a spill the worker may have run against the OLD safe
        # extent (the defer fires mid-commit, before this advance) —
        # enqueue coalesces with an already-queued task
        maint = self.engine.maintenance
        if maint is not None and doc.tree._log.tiering_enabled \
                and doc.tree._log.spill_due():
            maint.enqueue("spill", doc)
        doc.commit_ms.observe(total_ms)
        self.engine.record_commit(doc, ct)

    def _commit_single(self, item: _WorkItem) -> None:
        doc, tickets, fused, spans, ct = item
        n = fused.num_ops
        doc._commit_saved = doc.tree.begin_commit()
        try:
            with self.engine.audit_commit(ct), ct.stage("merge"):
                doc.tree.apply_packed_chunked(fused, self.engine.chunk_ops)
        except CRDTError:
            self._sequential(doc, tickets, ct)
            return
        chunks = max(1, -(-n // self.engine.chunk_ops))
        doc.chunks_launched += chunks
        ct.chunk_count = chunks
        self._attribute_and_publish(doc, tickets, spans,
                                    doc.tree.last_applied_mask, ct)

    def _sequential(self, doc, tickets: List[WriteTicket],
                    ct: CommitTrace) -> None:
        """Per-ticket fallback after a fused batch rejected: each delta
        applies (or 409s) on its own, exactly like the unfused service —
        only the guilty request fails."""
        self.engine.counters.add("sequential_fallbacks")
        any_applied = False
        any_rejected = False
        for t in tickets:
            if t.n_leaves == 0:
                self.engine.finish_ticket(doc, t, np.zeros(0, dtype=bool))
                continue
            try:
                with ct.stage("merge"):
                    doc.tree.apply_packed_chunked(t.packed,
                                                  self.engine.chunk_ops)
            except CRDTError:
                self.engine.reject_ticket(doc, t)
                any_rejected = True
            else:
                ct.chunk_count += max(
                    1, -(-t.n_leaves // self.engine.chunk_ops))
                mask = doc.tree.last_applied_mask
                self.engine.finish_ticket(doc, t, mask)
                ct.applied_ops += int(mask.sum())
                any_applied = any_applied or bool(mask.any())
                # durable ack: each applied ticket's ops become one
                # WAL record (end_pos = the log right after ITS apply)
                if doc.wal is not None and mask.any() and \
                        not self._wal_append(doc, tickets, ct,
                                             t.packed, mask):
                    return
        ct.dup_ops = sum(t.n_leaves for t in tickets
                         if t.accepted) - ct.applied_ops
        if not any_rejected:
            ct.outcome = "committed"
        elif any(t.accepted and t.n_leaves for t in tickets):
            # empty deltas resolve accepted but carry nothing — they
            # must not promote an all-rejected round to "partial"
            ct.outcome = "partial"
        else:
            ct.outcome = "rejected"
        if doc.wal is not None and any_applied:
            if self.engine.wal_sync == "batch":
                self._defer_commit(doc, tickets, ct)
                return
            if not self._wal_sync_now(doc, tickets, ct):
                return
        if any_applied:
            with ct.stage("publish"):
                ct.staleness_s = doc.publish()
        self.engine.stamp_visibility(doc, ct, _commit_ms(ct))
        for t in tickets:
            t.done.set()

    def _attribute_and_publish(self, doc, tickets, spans,
                               mask: np.ndarray,
                               ct: CommitTrace) -> None:
        for t, (s, e) in zip(tickets, spans):
            self.engine.finish_ticket(doc, t, mask[s:e])
        ct.applied_ops = int(mask.sum())
        ct.dup_ops = ct.num_ops - ct.applied_ops
        ct.outcome = "committed"
        fault = self.engine.fault
        if fault is not None and fault.pop("drop"):
            # injected dropped-ack (GRAFT_ORACLE_FAULT=drop,
            # obs/oracle.py): ack the tickets WITHOUT publishing the
            # snapshot and WITHOUT a flight record — the merged ops sit
            # silently in the tree until some later commit publishes
            # them, exactly the failure shape the oracle's
            # quiescence check must catch (an acked trace id that never
            # appears in the commit stream)
            ct.outcome = "dropped"
            for t in tickets:
                t.done.set()
            return
        if doc.wal is not None and mask.any():
            # durable ack: the commit's applied rows hit the WAL (and
            # disk) BEFORE the snapshot publishes or any ticket
            # resolves — the crash window between merge and fsync
            # loses only un-acked work
            if not self._wal_append(doc, tickets, ct, ct.packed, mask):
                return
            if self.engine.wal_sync == "batch":
                # group commit: fsync once per doc at the round
                # barrier (serialized) or on the WAL-sync worker
                # (pipelined); publish + ack wait for it
                self._defer_commit(doc, tickets, ct)
                return
            if not self._wal_sync_now(doc, tickets, ct):
                return
        if mask.any():
            with ct.stage("publish"):
                ct.staleness_s = doc.publish()
        self.engine.stamp_visibility(doc, ct, _commit_ms(ct))
        for t in tickets:
            t.done.set()

    # -- write-ahead log (wal.py; docs/DURABILITY.md) ----------------------

    def _defer_commit(self, doc, tickets: List[WriteTicket],
                      ct: CommitTrace) -> None:
        """Batch mode: park one document's commit for the round's
        group fsync — inline at the round barrier (serialized) or on
        the WAL-sync worker (pipelined).  The entry carries the
        pre-commit state for the shed rollback and, pipelined, the
        records encoded during compute (landed at the barrier)."""
        ct.wal_deferred = True
        entry = PendingCommit(doc, tickets, ct, publish_needed=True)
        entry.saved = doc._commit_saved
        doc._commit_saved = None
        entry.log_len = doc.tree.log_length
        entry.records, doc._round_records = doc._round_records, []
        self._wal_round.append(entry)

    def _wal_append(self, doc, tickets: List[WriteTicket],
                    ct: CommitTrace, packed, mask: np.ndarray) -> bool:
        """Append the applied rows of one commit (or one sequential
        ticket) to the document's WAL — or, on the pipelined batch
        path, ENCODE the record only (the bytes land at the round
        barrier, strictly after the previous round's fsync job
        resolved, so a failed fsync can never orphan a later round's
        already-appended record).  False = the disk refused: every
        unresolved ticket was shed with an honest 503
        (:class:`WalUnavailable`) and the commit records as an
        error — the scheduler survives, the server keeps serving."""
        applied = int(mask.sum())
        sel = packed if applied == packed.num_ops else \
            packed_mod.select_rows(packed, np.nonzero(mask)[0])
        try:
            with ct.stage("wal_append"):
                if self._pipeline_active() \
                        and self.engine.wal_sync == "batch":
                    doc._round_records.append(
                        doc.wal.encode(sel, doc.tree.log_length))
                else:
                    doc.wal.append(sel, doc.tree.log_length)
        except OSError as e:
            self._wal_shed(doc, tickets, ct, e)
            return False
        return True

    def _wal_sync_now(self, doc, tickets: List[WriteTicket],
                      ct: CommitTrace) -> bool:
        """``GRAFT_WAL_SYNC=commit``: fsync this commit's record(s)
        inline, between the two ack-boundary kill sites."""
        wal_mod.maybe_crash("ack-pre-fsync")
        try:
            with ct.stage("wal_fsync"):
                doc.wal.sync()
        except OSError as e:
            self._wal_shed(doc, tickets, ct, e)
            return False
        wal_mod.maybe_crash("post-fsync-pre-publish")
        doc.wal_mark_durable()
        return True

    def _wal_shed(self, doc, tickets: List[WriteTicket],
                  ct: CommitTrace, e: Exception,
                  saved=_SAVED_UNSET) -> None:
        """Durability refused (ENOSPC/EIO): withhold the acks AND roll
        the merge back, so the log never holds ops that live in
        neither the tiers nor the WAL (a later acked write could
        causally depend on them — a disk hiccup must not become acked
        loss at the next crash).  The client retries; once the disk
        recovers the replayed delta applies for real.  ``saved`` is
        the pre-commit state to roll back to — defaults to the
        document's in-flight commit save; deferred entries pass their
        own (the save moved into the entry at defer time)."""
        self.engine.counters.add("wal_shed_commits")
        if saved is _SAVED_UNSET:
            saved = doc._commit_saved
            doc._commit_saved = None
        if saved is not None:
            try:
                doc.tree.rollback_commit(saved)
            except Exception:   # noqa: BLE001 — rollback is best-
                # effort containment; failing it leaves merged
                # un-acked ops (the pre-rollback semantics), counted
                self.engine.counters.add("wal_rollback_errors")
            doc._safe_extent = min(doc._safe_extent,
                                   doc.tree.log_length)
        err = WalUnavailable(
            f"write-ahead log unavailable for {doc.doc_id!r}: {e!r}")
        err.__cause__ = e
        for t in tickets:
            if not t.done.is_set():
                t.error = err
                t.done.set()
        ct.outcome = "error"
        ct.error = f"wal: {e!r}"
        ct.wal_deferred = False

    def _finish_wal_round(self) -> None:
        """The group-commit barrier: every commit the round merged
        gets its fsync AFTER all the round's compute (merges never
        interleave with fsync waits), and ONE fsync per document
        covers every ticket coalesced into its commit.  Each document
        resolves right after its OWN fsync — a round touching many
        documents must not couple their fsync latencies into every
        ack (fsyncs are per-doc files; a cross-doc barrier would add
        latency without saving a single call).  fsync latency is
        billed into each commit's ``wal_fsync`` stage (the flight
        recorder's view of the durability tax).

        SHARED-stream mode (engine.shared_wal): every document's
        records landed in ONE file, so here the barrier really is one
        ``fsync`` covering all of them — fsyncs/round collapses from
        O(docs touched) to 1 at the same fsync-before-ack durability
        point, and per-doc resolution follows the single call (no
        added coupling: the call they all wait on IS the one call
        made)."""
        pending, self._wal_round = self._wal_round, []
        if not pending:
            return
        if self.engine.shared_wal is not None:
            self._finish_wal_round_shared(pending)
            return
        for entry in pending:
            doc, tickets, ct = entry.doc, entry.tickets, entry.ct
            wal_mod.maybe_crash("ack-pre-fsync")
            t0 = time.perf_counter()
            try:
                doc.wal.sync()
            except OSError as e:
                self._wal_shed(doc, tickets, ct, e, saved=entry.saved)
                self.engine.record_commit(doc, ct)
                continue
            ms = (time.perf_counter() - t0) * 1e3
            wal_mod.maybe_crash("post-fsync-pre-publish")
            doc.wal_mark_durable()
            ct.stages_ms["wal_fsync"] = round(
                ct.stages_ms.get("wal_fsync", 0.0) + ms, 3)
            t0 = time.perf_counter()
            if entry.publish_needed:
                with ct.stage("publish"):
                    ct.staleness_s = doc.publish()
            ct.wal_deferred = False
            ct.total_ms = round(
                ct.total_ms + ms
                + (time.perf_counter() - t0) * 1e3, 3)
            self.engine.stamp_visibility(doc, ct, ct.total_ms)
            for t in tickets:
                t.done.set()
            doc.commit_ms.observe(ct.total_ms)
            self.engine.record_commit(doc, ct)
            doc.note_durable(entry.log_len)

    def _finish_wal_round_shared(
            self, pending: List[PendingCommit]) -> None:
        """Shared-stream barrier: one fsync, then per-doc durable
        marks, publishes, and ticket resolution.  A failed fsync
        sheds and rolls back EVERY commit it covered — their records
        share the dropped unsynced tail, exactly the per-doc rule
        applied once."""
        wal_mod.maybe_crash("ack-pre-fsync")
        shared = self.engine.shared_wal
        t0 = time.perf_counter()
        try:
            shared.sync(covered_docs=len(pending))
        except OSError as e:
            for entry in pending:
                self._wal_shed(entry.doc, entry.tickets, entry.ct, e,
                               saved=entry.saved)
                self.engine.record_commit(entry.doc, entry.ct)
            return
        ms = (time.perf_counter() - t0) * 1e3
        wal_mod.maybe_crash("post-fsync-pre-publish")
        self.engine.counters.add("wal_shared_rounds")
        self.engine.counters.add("wal_shared_covered_docs",
                                 len(pending))
        for entry in pending:
            doc, tickets, ct = entry.doc, entry.tickets, entry.ct
            doc.wal_mark_durable()
            ct.stages_ms["wal_fsync"] = round(
                ct.stages_ms.get("wal_fsync", 0.0) + ms, 3)
            t1 = time.perf_counter()
            if entry.publish_needed:
                with ct.stage("publish"):
                    ct.staleness_s = doc.publish()
            ct.wal_deferred = False
            ct.total_ms = round(
                ct.total_ms + ms
                + (time.perf_counter() - t1) * 1e3, 3)
            self.engine.stamp_visibility(doc, ct, ct.total_ms)
            for t in tickets:
                t.done.set()
            doc.commit_ms.observe(ct.total_ms)
            self.engine.record_commit(doc, ct)
            doc.note_durable(entry.log_len)

    # -- the two-stage pipeline (serve/workers.py) ---------------

    def _barrier_and_submit(self, pending: List[PendingCommit]) -> None:
        """The pipelined round barrier: join the in-flight fsyncs
        this round CONFLICTS with, roll back anything that failed
        (shedding this round's commits on the same documents — they
        causally sit on top), land this round's encoded WAL records,
        and queue the round to the WAL-sync worker.  The scheduler
        then immediately computes the next round while these fsyncs
        are in flight — round time becomes max(compute, fsync)
        instead of their sum.

        The barrier's scope matches the WAL layout: per-doc files are
        independent streams, so only documents with their OWN earlier
        entry still in flight wait (rare — a closed-loop client can't
        have two outstanding writes); the shared stream is one file
        with one ordering, so it joins the whole lane."""
        sync = self.engine.sync_worker
        if self.engine.shared_wal is not None:
            while not sync.wait_idle(0.25):
                if sync.crashed or self._sync_crashed:
                    raise wal_mod.CrashPoint("wal-sync worker died")
        else:
            conflicted = [e.doc for e in pending
                          if e.doc._sync_inflight]
            while conflicted and not sync.wait_docs_clear(
                    conflicted, 0.25):
                if sync.crashed or self._sync_crashed:
                    raise wal_mod.CrashPoint("wal-sync worker died")
        pending = self._service_failures(pending)
        # matz refreshes due on documents NOT in this round can
        # snapshot now: the sync lane is idle, so everything their
        # coverage includes is fsync-durable
        self._pickup_matz(exclude={id(e.doc) for e in pending})
        ok: List[PendingCommit] = []
        for entry in pending:
            try:
                with entry.ct.stage("wal_append"):
                    for rec in entry.records:
                        entry.doc.wal.append_encoded(rec)
            except OSError as e:
                self._wal_shed(entry.doc, entry.tickets, entry.ct, e,
                               saved=entry.saved)
                self.engine.record_commit(entry.doc, entry.ct)
                continue
            ok.append(entry)
        if not ok:
            return
        # chaos site: records appended (page cache) but the fsync job
        # not yet queued — no ack was released, so recovery may
        # restore these ops (un-acked survival) or lose them (torn
        # tail), both legal; acked state is exactly the previous
        # round's
        wal_mod.maybe_crash("pre-queue-fsync")
        self.engine.counters.add("pipeline_rounds")
        sync.submit(ok)

    def _service_failures(
            self, pending: List[PendingCommit] = ()
    ) -> List[PendingCommit]:
        """Roll back and resolve commits the WAL-sync worker handed
        back (failed fsync).  Runs on the scheduler thread — the only
        thread allowed to mutate trees — BEFORE this round's records
        land: a pending commit on a failed document is shed too
        (rolled back to the EARLIEST doomed commit's pre-state), so
        nothing from a later round can publish over a hole.  Returns
        the pending entries that survive."""
        with self.cond:
            failed, self._failed_sync = list(self._failed_sync), []
        if not failed:
            return list(pending)
        by_doc: dict = {}
        for entry in failed:
            by_doc.setdefault(id(entry.doc), []).append(entry)
        out: List[PendingCommit] = []
        for entry in pending:
            group = by_doc.get(id(entry.doc))
            if group is not None:
                entry.error = group[0].error
                group.append(entry)
            else:
                out.append(entry)
        for group in by_doc.values():
            doc = group[0].doc
            saveds = [e.saved for e in group if e.saved is not None]
            if saveds:
                earliest = min(saveds, key=lambda s: s[0])
                try:
                    doc.tree.rollback_commit(earliest)
                except Exception:   # noqa: BLE001 — rollback is best-
                    # effort containment (counted, same rule as
                    # _wal_shed)
                    self.engine.counters.add("wal_rollback_errors")
                doc._safe_extent = min(doc._safe_extent,
                                       doc.tree.log_length)
            for entry in group:
                self.engine.counters.add("wal_shed_commits")
                self.engine.counters.add("pipeline_shed_commits")
                self._resolve_shed(entry)
        return out

    def _pickup_matz(self, exclude=frozenset()) -> None:
        """Hand due materialization refreshes to the maintenance
        worker: snapshot the mirror copy-on-export on THIS thread (the
        mirror's only writer), serialize on the worker.  Only runs
        while the sync lane is idle and never for documents with a
        commit in the current round — the artifact's coverage may only
        ever include fsync-durable ops."""
        eng = self.engine
        maint = eng.maintenance
        if maint is None:
            return
        sync = eng.sync_worker
        if sync is not None and not sync.idle():
            return
        for doc in eng.docs():
            if not doc._matz_due or id(doc) in exclude:
                continue
            try:
                snap = doc.tree.matz_snapshot()
            except Exception:   # noqa: BLE001 — the artifact is an
                # accelerator; CrashPoint (BaseException) propagates
                eng.counters.add("matz_write_errors")
                doc._matz_due = False
                continue
            if snap is None:
                doc._matz_due = False
                continue
            # clear the flag only once the task is ON the queue: the
            # flush() barrier keys quiescence off due-or-queued, and
            # a window where the refresh is neither would let it
            # report done with the export still owed.  A full queue
            # keeps the flag raised — a later pickup retries instead
            # of silently dropping the refresh forever.
            if maint.enqueue("matz", doc, snap):
                doc._matz_due = False

    # -- cross-document batched launch ------------------------------------

    def _process_grouped(self, grouped: List[_WorkItem]) -> None:
        """≥2 documents' kernel merges as ONE batched merge on the
        engine's device: the replica engine's grouped merge
        (``engine.apply_packed_grouped``), which builds each candidate
        set in its row of one column frame at a shared capacity, the
        stack on a leading doc axis (so each document's parked table
        stays row-consistent with its own columns).  Each document
        commits under :meth:`_guarded` and falls back per-document only
        for CRDT rejections (sequential replay attributes the guilty
        ticket); a failed launch surfaces on every grouped ticket."""
        from .. import engine as engine_mod
        t0 = time.perf_counter()
        times: dict = {}

        def each(i: int, commit) -> None:
            item = grouped[i]
            if i == 0:
                self.engine.counters.add("cross_doc_batches")
                self.engine.counters.add("cross_doc_docs", len(grouped))
            # the group's shared wall time is billed to every member
            # commit's breakdown (it gated all of them equally), split
            # so "batched_launch" means the batched merge alone:
            # the prepares, each filling its row of the stack, land in
            # their own stage
            item[4].stages_ms["batch_prepare"] = round(
                times["prepare_ms"], 3)
            item[4].stages_ms["batched_launch"] = round(
                times["launch_ms"], 3)
            item[4].batch_width = len(grouped)
            self._guarded(self._finish_grouped, item, commit)

        try:
            engine_mod.apply_packed_grouped(
                [item[0].tree for item in grouped],
                [item[2] for item in grouped], times=times, each=each)
        except Exception as e:   # noqa: BLE001 — launch failed before any
            # commit (each commit is guarded): every grouped document's
            # tickets get the error
            self.engine.counters.add("scheduler_errors")
            traceback.print_exc(file=sys.stderr)
            err = SchedulerError(f"batched launch failed: {e!r}")
            err.__cause__ = e
            for doc, tickets, _, _, ct in grouped:
                for t in tickets:
                    t.error = err
                    t.done.set()
                ct.outcome = "error"
                ct.error = repr(e)
                ct.total_ms = (time.perf_counter() - t0) * 1e3
                self.engine.record_commit(doc, ct)

    def _finish_grouped(self, item: _WorkItem, commit) -> None:
        """One document's commit against its slice of a batched table:
        ``commit()`` runs its ``finish_packed``."""
        doc, tickets, fused, spans, ct = item
        doc.chunks_launched += 1
        ct.chunk_count = 1
        doc._commit_saved = doc.tree.begin_commit()
        try:
            with ct.stage("merge"):
                commit()
        except CRDTError:
            self._sequential(doc, tickets, ct)
            return
        self._attribute_and_publish(doc, tickets, spans,
                                    doc.tree.last_applied_mask, ct)

    def _process_remote(self, items: List[_WorkItem]) -> None:
        """The merge tier's async remote-merge stage (docs/MERGETIER.md):
        prepare each document's candidate set locally (exactly what the
        local grouped launch would stack), ship the round to the worker
        pool in one fan-out (so even a single front-end's documents ride
        ONE worker linger window), then commit each verified frame with
        the SAME ``finish_packed`` the local grouped path uses — the
        frame's columns are re-aligned from OUR candidate copy
        (``with_capacity`` to the worker's shared capacity, the
        deterministic twin of ``stack_aligned``'s alignment), so the
        worker contributes compute, never state.  Every per-document
        failure — transport, timeout, digest, dry-check, breaker —
        falls back to the bit-identical local merge; nothing is acked
        before its commit, so a dead worker can only cost latency."""
        from ..codec import packed as pk
        from ..mergetier.client import MergeFallback
        mt = self.engine.mergetier
        reqs = []
        for item in items:
            doc, _, fused, _, ct = item
            t0 = time.perf_counter()
            try:
                with profiling.span("serve.batch_prepare"):
                    prep = doc.tree.prepare_packed(fused)
            except Exception:   # noqa: BLE001 — a failed local prepare
                # falls back whole (the local path re-prepares; if the
                # failure is real it surfaces there, guarded)
                prep = None
            ct.stages_ms["batch_prepare"] = round(
                (time.perf_counter() - t0) * 1e3, 3)
            reqs.append((item, prep))
        sendable = [(item, prep) for item, prep in reqs
                    if prep is not None]
        ft = self.engine.fleettrace
        traced = fleettrace_mod.enabled()
        src = ft.node if ft is not None else mt.src

        def _tctx(ct):
            if not traced or not ct.trace_ids:
                return None
            return {"trace_ids": list(ct.trace_ids)[:8],
                    "span_ctx": fleettrace_mod.encode_span_ctx(
                        src, "remote_merge")}

        t0 = time.perf_counter()
        with profiling.span("serve.remote_merge"):
            results = mt.merge_round(
                [(item[0].doc_id, prep, item[2].num_ops,
                  _tctx(item[4]))
                 for item, prep in sendable])
        remote_ms = round((time.perf_counter() - t0) * 1e3, 3)
        # crash site: responses in hand, nothing committed or acked —
        # a front-end dying HERE must lose no acked write (the crash
        # matrix's mid-remote-merge leg)
        wal_mod.maybe_crash("mid-remote-merge")
        outcome = {id(item): None for item, _ in reqs}
        for (item, prep), res in zip(sendable, results):
            outcome[id(item)] = res
        for item, prep in reqs:
            ct = item[4]
            ct.stages_ms["remote_merge"] = remote_ms
            res = outcome[id(item)]
            if isinstance(res, tuple):
                table, shared, width, sub = res
                ct.batch_width = width
                if sub is not None:
                    # the worker's echoed split (satellite: transport
                    # vs linger-queue vs launch inside remote_merge)
                    ct.stages_ms["remote_transport"] = sub["transport"]
                    ct.stages_ms["remote_queue"] = sub["queue"]
                    ct.stages_ms["remote_launch"] = sub["launch"]
                    if ft is not None:
                        for tid in list(ct.trace_ids)[:8]:
                            ft.record(tid, "remote_merge",
                                      doc=item[0].doc_id,
                                      worker=sub["worker"],
                                      ms=remote_ms,
                                      transport_ms=sub["transport"],
                                      queue_ms=sub["queue"],
                                      launch_ms=sub["launch"])
                p = pk.with_capacity(prep, shared)
                self._guarded(self._finish_grouped, item,
                              functools.partial(item[0].tree.finish_packed,
                                                item[2], p, table))
            else:
                # MergeFallback (reason already counted by the client)
                # or an unsendable prepare: the bit-identical local
                # merge — same candidate set, same commit, same acks
                if isinstance(res, MergeFallback):
                    self.engine.counters.add("mergetier_fallbacks")
                self._guarded(self._commit_single, item)
