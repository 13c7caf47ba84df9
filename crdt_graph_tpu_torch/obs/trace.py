"""Trace context: the per-request ``trace_id`` and the per-commit
stage collector.

Lifecycle (docs/OBSERVABILITY.md):

1. **Mint at admission.**  The HTTP handler (service/http.py,
   ``POST /docs/{id}/ops``) mints a ``trace_id`` — or adopts a
   well-formed client-supplied ``X-Trace-Id`` header — before the body
   is parsed, so even a 400/429 is attributable.  Embedded callers of
   ``ServingEngine.submit`` get one minted for them.
2. **Ride the ticket.**  The id is stored on the
   :class:`~crdt_graph_tpu_torch.serve.queue.WriteTicket` together with the
   handler-thread parse time and the queue depth observed at admission.
3. **Coalesce.**  The scheduler fuses every ticket pending on a
   document into one commit; the commit's :class:`CommitTrace` carries
   ALL member trace_ids — a coalesced batch is attributable to every
   request it served, not just the first.
4. **Record.**  After publish (or rejection/error) the trace becomes a
   :class:`~crdt_graph_tpu_torch.obs.flight.CommitRecord` in the flight
   recorder, and the id is echoed to the client (response body +
   ``X-Trace-Id`` header) so a user report can be joined against the
   server-side record.
"""
from __future__ import annotations

import contextlib
import re
import time
import uuid
from typing import Dict, Optional, Tuple

# wire header for propagating / echoing the id (case-insensitive on
# ingest; http.client normalizes)
TRACE_HEADER = "X-Trace-Id"

# read-path correlation headers: every served read echoes the
# snapshot it resolved against, so a session checker can join reads to
# the commit stream without trusting the body
SESSION_HEADER = "X-Session-Id"
SNAP_FP_HEADER = "X-Snapshot-Fingerprint"
COMMIT_SEQ_HEADER = "X-Commit-Seq"

# fleet identity + sync-window headers (cluster/, docs/CLUSTER.md):
# every read served by a fleet node names the replica that answered
# (numeric leased id, stable node name, fencing-token epoch) plus the
# replica-independent state fingerprint, so staleness and convergence
# are wire-observable; the since-window headers make `/ops?since=`
# pulls bounded and resumable without touching the body format
REPLICA_HEADER = "X-Replica-Id"
REPLICA_NAME_HEADER = "X-Replica-Name"
REPLICA_EPOCH_HEADER = "X-Replica-Epoch"
STATE_FP_HEADER = "X-State-Fingerprint"
SINCE_NEXT_HEADER = "X-Since-Next"
SINCE_MORE_HEADER = "X-Since-More"
SINCE_FOUND_HEADER = "X-Since-Found"
FORWARDED_HEADER = "X-Fleet-Forwarded"
# anti-entropy pull attribution: the puller names itself so the
# serving node can fold the pull's ``since`` mark into its causal-
# stability watermark (min acked position across the fleet — what
# gates the cascade op-log's checkpoint advancement and segment GC;
# oplog.py, cluster/gateway.py update_stability)
AE_PEER_HEADER = "X-Ae-Peer"
# bounded-staleness read contract (docs/CLUSTER.md §Partitions &
# staleness): every fleet read stamps X-Ae-Lag-Seconds — the max
# seconds since any live peer was last fully synced, i.e. an upper
# bound on how stale this replica can be — and a read carrying
# X-Max-Staleness (seconds; or the server-wide GRAFT_MAX_STALENESS_S
# default) gets 503 + Retry-After instead of silently stale data when
# the replica is partitioned past the bound
AE_LAG_HEADER = "X-Ae-Lag-Seconds"
MAX_STALENESS_HEADER = "X-Max-Staleness"
# delta-push fan-out (serve/watch.py; docs/SERVING.md §Watch &
# fan-out): a watch delivery classifies itself — "notify" (delivered
# to a parked watcher), "resume" (data was already waiting), "timeout"
# (empty heartbeat; re-poll), "shed" (slow consumer handed back to
# polling), "closed" (engine shutdown).  A shed delivery also carries
# X-Watch-Resume-Since: the EXACT resumable window mark (the chain
# contract makes resume lossless), so shedding is an honest handoff,
# never silent data loss
WATCH_EVENT_HEADER = "X-Watch-Event"
WATCH_RESUME_HEADER = "X-Watch-Resume-Since"
# fleet-wide causal tracing (obs/fleettrace.py; docs/OBSERVABILITY.md
# §Fleet tracing & visibility ledger): X-Span-Ctx rides every
# inter-node hop a write takes (gateway forward, mergetier POST
# /merge, the canary's peer probes) naming the sending node, the hop
# kind, and the send timestamp — the receiving side appends its span
# under the same trace id so `GET /debug/trace/{id}` on ANY node can
# stitch the full causal tree.  X-Trace-Frontier is the anti-entropy
# twin: a windowed `/ops` response stamps the trace ids of the recent
# commits the window carries (plus the primary's send timestamp), so
# the PULLING node can stamp visible-at-replica without a new RPC.
# Both headers are emitted only while fleet tracing is enabled
# (GRAFT_FLEETTRACE=0 reverts the wire byte-identically).
SPAN_CTX_HEADER = "X-Span-Ctx"
TRACE_FRONTIER_HEADER = "X-Trace-Frontier"
# rejoining-node catch-up: a fleet read of a document this
# node doesn't hold yet — but a peer does — answers 503 + Retry-After
# instead of 404, with this hint: the best local estimate of the ops
# still to pull (peers-holding-the-doc count until the first window
# lands; the priority pull it triggers usually lands within one
# anti-entropy interval)
CATCHUP_REMAINING_HEADER = "X-Catchup-Remaining"

# accepted client-supplied ids: 8-64 url-safe chars (anything else is
# re-minted — the id lands in filenames and label values)
_TRACE_RE = re.compile(r"^[A-Za-z0-9_.-]{8,64}$")


def mint_trace_id() -> str:
    """A fresh 16-hex-char trace id (collision-safe for a single
    process's flight-recorder window)."""
    return uuid.uuid4().hex[:16]


def is_valid_id(candidate: Optional[str]) -> bool:
    """Whether a client-supplied trace/session id may be adopted
    (8-64 url-safe chars — it lands in filenames and label values)."""
    return bool(candidate and _TRACE_RE.match(candidate))


def ensure_trace_id(candidate: Optional[str]) -> str:
    """Adopt a well-formed client id, mint otherwise."""
    if is_valid_id(candidate):
        return candidate
    return mint_trace_id()


def ensure_session_id(candidate: Optional[str]) -> str:
    """Adopt a well-formed client ``X-Session-Id``, mint otherwise
    (same alphabet contract as trace ids — session ids land in oracle
    violation details and label values)."""
    return ensure_trace_id(candidate)


class CommitTrace:
    """Mutable per-commit collector the scheduler fills as it works.

    Created when a document's round is fused, finalized into a
    :class:`~crdt_graph_tpu_torch.obs.flight.CommitRecord` when the commit
    resolves.  Scheduler-thread owned; never shared across threads
    until handed to the recorder.
    """

    __slots__ = ("doc_id", "trace_ids", "n_tickets", "num_ops",
                 "parse_ms", "queue_depth_admission", "stages_ms",
                 "chunk_count", "applied_ops", "dup_ops", "outcome",
                 "staleness_s", "total_ms", "error", "packed",
                 "wal_deferred", "audit_sampled", "audit_result",
                 "batch_width", "t_start", "visibility_stamped")

    def __init__(self, doc_id: str, tickets) -> None:
        self.doc_id = doc_id
        self.trace_ids: Tuple[str, ...] = tuple(
            t.trace_id for t in tickets if t.trace_id)
        self.n_tickets = len(tickets)
        self.num_ops = sum(t.n_leaves for t in tickets)
        # parse happened per-ticket in the handler threads; the commit
        # bills the sum (the work its batch caused), and admission depth
        # is the deepest queue any member saw on entry
        self.parse_ms = round(sum(t.parse_ms for t in tickets), 3)
        self.queue_depth_admission = max(
            (t.depth_at_admission for t in tickets), default=0)
        self.stages_ms: Dict[str, float] = {}
        self.chunk_count = 0
        self.applied_ops = 0
        self.dup_ops = 0
        self.outcome = "pending"
        self.staleness_s: Optional[float] = None
        # (the published snapshot's seq + fingerprint are stamped by
        # ServingEngine.record_commit straight off doc.snapshot_view())
        self.total_ms = 0.0
        self.error: Optional[str] = None
        # the fused batch (NOT serialized): kept only so the sampled
        # chain audit can trace its shapes after the commit resolves
        self.packed = None
        # True while this commit awaits the round's group fsync
        # (serve/scheduler.py WAL batch mode): publish, ticket
        # resolution, and the flight record all happen at the barrier
        self.wal_deferred = False
        # the chain audit is sampled on the SCHEDULER thread (around a
        # single commit's own merge, or at prepare time for a pipelined
        # round); the record then uses the stored result instead of
        # sampling inline
        self.audit_sampled = False
        self.audit_result: Optional[Dict] = None
        # batched-launch width this commit rode in (local cross-doc
        # group size, or the merge worker's achieved cross-FLEET width
        # — docs/MERGETIER.md); None for per-document merges
        self.batch_width: Optional[int] = None
        # perf_counter at the start of the commit on the scheduler
        # thread, and whether its visibility stamps (the fleet's ledger
        # and spans) are in: they go in before its tickets resolve
        self.t_start = time.perf_counter()
        self.visibility_stamped = False

    @contextlib.contextmanager
    def stage(self, name: str, span_name: Optional[str] = None):
        """Time a commit stage into this trace AND the process-wide
        span registry (``serve.<name>`` unless overridden) — the
        per-commit breakdown and the aggregate stay one measurement."""
        from ..utils import profiling
        t0 = time.perf_counter()
        try:
            with profiling.span(span_name or f"serve.{name}"):
                yield
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            self.stages_ms[name] = round(
                self.stages_ms.get(name, 0.0) + ms, 3)

    def stage_breakdown(self) -> Dict[str, float]:
        """parse + the scheduler stages, one dict (record schema's
        ``stages_ms``)."""
        out = {"parse": self.parse_ms}
        out.update(self.stages_ms)
        return out
