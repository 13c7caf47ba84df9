"""Admission-controlled per-document write queues.

``POST /ops`` no longer applies inline: the handler thread parses the
wire body (native column parse for bootstrap-size pushes), wraps the
parsed delta in a :class:`WriteTicket`, and enqueues it on the
document's :class:`DocQueue`.  The merge scheduler drains whole queues
into fused batches; the handler blocks on the ticket until its commit's
snapshot is published (so a client's follow-up read sees its write),
then answers with the per-request outcome the scheduler attributed.

Admission control is the backpressure contract: a queue holds at most
``max_requests`` tickets and ``max_leaves`` pending leaves; past either
bound :meth:`DocQueue.offer` raises :class:`QueueFull` and the handler
answers ``429 Retry-After`` WITHOUT reading the tree or blocking — an
overloaded document sheds load at the door instead of collapsing the
scheduler, and the Retry-After estimate comes from the document's own
recent commit latency.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Deque, List, Optional

from ..codec.packed import PackedOps


class QueueFull(Exception):
    """Admission rejected: the document's merge queue is at capacity.
    ``retry_after_s`` is the server's drain-time estimate (the wire's
    Retry-After header)."""

    def __init__(self, doc_id: str, depth: int, retry_after_s: int):
        super().__init__(
            f"document {doc_id!r} merge queue full ({depth} pending); "
            f"retry in ~{retry_after_s}s")
        self.doc_id = doc_id
        self.depth = depth
        self.retry_after_s = retry_after_s


class SchedulerStopped(Exception):
    """The serving engine is shut down (or wedged past the wait
    deadline); the request was not merged."""


class WalUnavailable(SchedulerStopped):
    """The write-ahead log could not accept (or fsync) this commit's
    record — disk full, EIO.  Durability cannot be promised, so the
    ack is withheld and the HTTP layer answers an honest 503 (the
    SchedulerStopped mapping): the server keeps serving reads and
    sheds writes until the disk recovers, instead of crashing or —
    worse — acking into a log that lost the bytes.  The merge is
    ROLLED BACK (scheduler ``_wal_shed``) so the log never holds ops
    that live in neither the tiers nor the WAL; the client's retry
    applies for real once the disk recovers."""


class SchedulerError(Exception):
    """A non-CRDT failure while the scheduler processed this request's
    round (kernel launch failure, allocation failure, a bug).  Wraps
    the original as ``__cause__``; the HTTP layer maps it to 500 —
    NEVER to the 400/409 client-error classes, which would tell the
    client its well-formed request was at fault."""


class WriteTicket:
    """One parsed client delta awaiting its fused merge.

    The handler thread fills ``packed``/``n_leaves`` and waits on
    ``done``; the scheduler fills the outcome fields and sets ``done``
    only after the commit's snapshot is published.

    Trace context (obs/trace.py) rides the ticket: ``trace_id`` is the
    id minted at HTTP admission (every commit record in the flight
    recorder carries all member tickets' ids), ``parse_ms`` the
    handler-thread wire-parse time this request cost, and
    ``depth_at_admission`` the queue depth observed when the ticket was
    accepted — together the per-request half of the commit's stage
    breakdown."""

    __slots__ = ("packed", "n_leaves", "enqueued_at",
                 "done", "accepted", "applied_count", "applied_op",
                 "error", "trace_id", "parse_ms", "depth_at_admission")

    def __init__(self, packed: PackedOps, n_leaves: int,
                 trace_id: str = "", parse_ms: float = 0.0):
        self.packed = packed
        self.n_leaves = n_leaves
        self.enqueued_at = time.monotonic()
        self.done = threading.Event()
        self.accepted: Optional[bool] = None
        self.applied_count = 0
        self.applied_op = None          # Operation echo, or None
        self.error: Optional[BaseException] = None
        self.trace_id = trace_id
        self.parse_ms = parse_ms
        self.depth_at_admission = 0

    def wait(self, timeout: Optional[float]) -> None:
        """Block until the scheduler resolved this ticket; raise what it
        recorded (engine errors propagate to the handler's own
        except-clauses, exactly like the inline-apply path did)."""
        if not self.done.wait(timeout):
            raise SchedulerStopped(
                f"merge not scheduled within {timeout}s")
        if self.error is not None:
            raise self.error


class DocQueue:
    """FIFO of pending tickets for one document, with bounded depth.

    Thread contract: ``offer`` under the scheduler condition (many
    handler threads), ``drain`` by the scheduler thread only."""

    def __init__(self, max_requests: int = 256,
                 max_leaves: int = 4_000_000):
        self._q: Deque[WriteTicket] = collections.deque()
        self._leaves = 0
        self.max_requests = max_requests
        self.max_leaves = max_leaves

    def __len__(self) -> int:
        return len(self._q)

    def pending_leaves(self) -> int:
        return self._leaves

    def offer(self, t: WriteTicket, retry_after_s: int,
              doc_id: str) -> None:
        if (len(self._q) >= self.max_requests
                or self._leaves + t.n_leaves > self.max_leaves):
            raise QueueFull(doc_id, len(self._q), retry_after_s)
        t.depth_at_admission = len(self._q)
        self._q.append(t)
        self._leaves += t.n_leaves

    def drain(self) -> List[WriteTicket]:
        """All currently pending tickets, FIFO (one coalesced round)."""
        out = list(self._q)
        self._q.clear()
        self._leaves = 0
        return out
