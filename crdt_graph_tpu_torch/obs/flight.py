"""The flight recorder: a bounded ring of per-commit records that
survives to disk exactly when something went wrong.

Every commit the scheduler resolves becomes one :class:`CommitRecord`:
stage span breakdown (parse/fuse/merge/publish), batch composition
(num_ops, coalesce width, chunk count), queue depth at admission,
snapshot staleness at publish, result fingerprint, the member
trace_ids, and — every Nth commit — a sampled
:mod:`~crdt_graph_tpu_torch.utils.chainaudit` summary of its merge (its
memory passes, kernel calls and host syncs held to the audit's budgets),
which turns the budgets into a production tripwire.

The ring is bounded (O(capacity) memory forever) and ``dump()`` writes
it as JSONL for post-mortem.  Dumps trigger automatically on:

- **SLO breach** — commit latency over ``slo_ms``
  (``GRAFT_SLO_MS``, default 1000 ms);
- **audit failure** — a sampled chain audit with ``ok: false`` (the
  merge grew past its budgets in production);
- **engine exception** — a commit that resolved with
  ``outcome: "error"`` (the scheduler survived, the evidence is on
  disk).

Dumps are rate-limited per reason (``min_dump_interval_s``) so a
sustained breach cannot turn the recorder into a disk-filling loop.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

# dump-trigger reasons (also the filename tag and the prom label)
REASON_SLO = "slo"
REASON_AUDIT = "audit"
REASON_ERROR = "error"
REASON_ORACLE = "oracle"     # a session-guarantee violation (obs/oracle.py)
REASON_MANUAL = "manual"


from ..utils.hostenv import env_int as _env_int  # noqa: E402 — the
# canonical int-env parser (shared with serve/engine.py's
# GRAFT_OPLOG_* knobs)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


@dataclasses.dataclass
class CommitRecord:
    """One resolved commit, as the flight recorder keeps it.

    ``stages_ms`` is the per-stage wall breakdown
    (parse/fuse/merge/publish, plus ``batched_launch`` for cross-doc
    rounds); ``audit`` is the sampled chainaudit summary dict (or
    None on unsampled commits); ``outcome`` is one of ``committed`` /
    ``partial`` (sequential fallback, some tickets 409'd) /
    ``rejected`` / ``noop`` (only empty deltas) / ``error``.
    """
    seq: int                      # recorder-global, monotone
    ts: float                     # epoch seconds at resolution
    doc_id: str
    trace_ids: Tuple[str, ...]
    outcome: str
    num_ops: int
    applied_ops: int
    dup_ops: int
    coalesce_width: int           # tickets fused into this commit
    chunk_count: int
    queue_depth_admission: int
    stages_ms: Dict[str, float]
    total_ms: float
    staleness_s: Optional[float]  # previous snapshot's age at publish
    snapshot_seq: Optional[int]
    fingerprint: Optional[str]
    # batched-launch width the commit rode in: local cross-doc group
    # size, or the merge worker's achieved cross-fleet width
    # (docs/MERGETIER.md); None for per-document merges
    batch_width: Optional[int] = None
    audit: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    # persisted materialization (docs/DURABILITY.md §Cold paths):
    # True/False on commits of a RECOVERED durable document — whether
    # its first-read state came off the matz artifact; None elsewhere
    matz_hit: Optional[bool] = None

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class FlightRecorder:
    """Bounded, thread-safe ring of :class:`CommitRecord` with
    automatic JSONL dumps.  One recorder per process by default
    (:func:`get_default_recorder`) — like the span registry, the
    post-mortem surface is process-wide."""

    def __init__(self, capacity: Optional[int] = None,
                 slo_ms: Optional[float] = None,
                 dump_dir: Optional[str] = None,
                 audit_every: Optional[int] = None,
                 audit_min_ops: Optional[int] = None,
                 min_dump_interval_s: float = 5.0):
        self.capacity = capacity if capacity is not None else \
            max(8, _env_int("GRAFT_FLIGHT_CAPACITY", 256))
        self.slo_ms = slo_ms if slo_ms is not None else \
            _env_float("GRAFT_SLO_MS", 1000.0)
        self.dump_dir = dump_dir or os.environ.get(
            "GRAFT_FLIGHT_DIR") or os.path.join(
                tempfile.gettempdir(), "crdt_flight")
        # 0 disables audit sampling entirely
        self.audit_every = audit_every if audit_every is not None else \
            _env_int("GRAFT_OBS_AUDIT_EVERY", 64)
        # batches below this width never sample: the chain budget is a
        # production-scale contract — small/padded traces legitimately
        # exceed it (compact tiers dominate a tiny threshold) and would
        # fire spurious audit dumps; 64k is the measured floor where
        # the audited fast path meets its CI budget
        self.audit_min_ops = audit_min_ops if audit_min_ops is not None \
            else _env_int("GRAFT_OBS_AUDIT_MIN_OPS", 65536)
        self.min_dump_interval_s = min_dump_interval_s
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._records_total = 0
        self._dumps: Dict[str, int] = {}
        self._last_dump_at: Dict[str, float] = {}
        self._last_dump_path: Optional[str] = None
        self._slo_breaches = 0
        self._audit_failures = 0
        self._errors = 0
        self._last_commit_ms = 0.0
        self._listeners: List[Any] = []
        self._listener_errors = 0

    # -- listeners --------------------------------------------------------

    def add_listener(self, fn) -> None:
        """Subscribe ``fn(record_dict)`` to every future record — the
        in-process push feed (the session-guarantee oracle consumes
        commit records this way instead of polling ``/debug/flight``).
        Called on the recording thread (the scheduler): listeners must
        be fast and must not block."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    # -- sampling ---------------------------------------------------------

    def audit_due(self, num_ops: int) -> bool:
        """True when the NEXT recorded commit should carry a sampled
        chain audit: every ``audit_every``th record, and only for
        batches at or above ``audit_min_ops`` (see ``__init__`` — the
        budget verdict is meaningless below production width)."""
        if self.audit_every <= 0 or num_ops < self.audit_min_ops:
            return False
        with self._lock:
            return self._records_total % self.audit_every == 0

    # -- recording --------------------------------------------------------

    def record(self, rec_fields: Dict[str, Any]) -> Optional[str]:
        """Append one commit record (field dict sans ``seq``/``ts``)
        and fire any dump triggers.  Returns the dump path when a dump
        was written, else None.  Never raises: a failed disk dump is
        counted and swallowed (the recorder must not take down the
        scheduler)."""
        with self._lock:
            self._seq += 1
            rec = CommitRecord(seq=self._seq, ts=time.time(),
                               **rec_fields)
            self._ring.append(rec)
            self._records_total += 1
            self._last_commit_ms = rec.total_ms
            reason = None
            if rec.outcome == "error":
                self._errors += 1
                reason = REASON_ERROR
            if rec.audit is not None and not rec.audit.get("ok", True):
                self._audit_failures += 1
                reason = reason or REASON_AUDIT
            if self.slo_ms > 0 and rec.total_ms > self.slo_ms:
                self._slo_breaches += 1
                reason = reason or REASON_SLO
            listeners = list(self._listeners)
        # the push feed runs OUTSIDE the recorder lock (a listener may
        # take its own locks — the oracle does) but still on the
        # recording thread; a failing listener is counted, never raised
        if listeners:
            payload = rec.to_json()
            for fn in listeners:
                try:
                    fn(payload)
                except Exception:    # noqa: BLE001 — listener boundary
                    with self._lock:
                        self._listener_errors += 1
        if reason is None:
            return None
        try:
            return self.dump(reason)
        except OSError:
            with self._lock:
                self._dumps["failed"] = self._dumps.get("failed", 0) + 1
            return None

    # -- dumping ----------------------------------------------------------

    def dump(self, reason: str = REASON_MANUAL) -> Optional[str]:
        """Write the ring (oldest first) as JSONL: one meta line, then
        one line per record.  Rate-limited per reason for the automatic
        triggers; ``manual`` always writes.  The rate-limit timestamp
        and the dump counter advance only AFTER the file is on disk —
        a failed write must neither suppress the next trigger's retry
        nor report evidence that was never captured."""
        now = time.monotonic()
        with self._lock:
            if reason != REASON_MANUAL:
                last = self._last_dump_at.get(reason)
                if last is not None and \
                        now - last < self.min_dump_interval_s:
                    self._dumps["suppressed"] = \
                        self._dumps.get("suppressed", 0) + 1
                    return None
            records = list(self._ring)
            seq = self._seq
        os.makedirs(self.dump_dir, exist_ok=True)
        path = os.path.join(
            self.dump_dir,
            f"flight_{os.getpid()}_{seq:08d}_{reason}.jsonl")
        with open(path, "w") as f:
            f.write(json.dumps({"flight_dump": True, "reason": reason,
                                "pid": os.getpid(), "at": time.time(),
                                "records": len(records),
                                "slo_ms": self.slo_ms,
                                "capacity": self.capacity}) + "\n")
            for rec in records:
                f.write(json.dumps(rec.to_json()) + "\n")
        with self._lock:
            self._last_dump_at[reason] = now
            self._dumps[reason] = self._dumps.get(reason, 0) + 1
            self._last_dump_path = path
        return path

    # -- exposition -------------------------------------------------------

    def records(self) -> List[CommitRecord]:
        with self._lock:
            return list(self._ring)

    def stats(self) -> Dict[str, Any]:
        """Counter/gauge view (bench output + prom gauges)."""
        with self._lock:
            return {
                "capacity": self.capacity,
                "slo_ms": self.slo_ms,
                "audit_every": self.audit_every,
                "audit_min_ops": self.audit_min_ops,
                "records": len(self._ring),
                "records_total": self._records_total,
                "slo_breaches": self._slo_breaches,
                "audit_failures": self._audit_failures,
                "errors": self._errors,
                "dumps": dict(self._dumps),
                "last_dump_path": self._last_dump_path,
                "last_commit_ms": round(self._last_commit_ms, 3),
                "listener_errors": self._listener_errors,
            }

    def debug_view(self) -> Dict[str, Any]:
        """The enriched ``GET /debug/flight`` payload: config +
        counters + the full ring as JSON records (newest last)."""
        out = self.stats()
        out["records"] = [r.to_json() for r in self.records()]
        return out

    def reset(self) -> None:
        """Drop all records and counters (tests; the autouse conftest
        fixture calls this between tests)."""
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self._records_total = 0
            self._dumps = {}
            self._last_dump_at = {}
            self._last_dump_path = None
            self._slo_breaches = 0
            self._audit_failures = 0
            self._errors = 0
            self._last_commit_ms = 0.0
            self._listeners = []
            self._listener_errors = 0


# -- process-wide default -------------------------------------------------

_default: Optional[FlightRecorder] = None
_default_lock = threading.Lock()


def get_default_recorder() -> FlightRecorder:
    """The process-wide recorder (lazily built from env defaults).
    ``ServingEngine`` uses it unless handed an explicit instance, so
    every engine in a process shares one post-mortem surface — the
    flight-recorder counterpart of the span registry."""
    global _default
    with _default_lock:
        if _default is None:
            _default = FlightRecorder()
        return _default


def reset_default_recorder() -> None:
    """Reset (not replace) the default recorder if it exists — keeps
    references held by live engines valid across test boundaries."""
    with _default_lock:
        if _default is not None:
            _default.reset()
