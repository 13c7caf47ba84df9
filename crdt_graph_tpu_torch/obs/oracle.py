"""Online session-guarantee oracle: RA-linearizability checks over the
trace/flight stream.

The serving stack makes every commit observable (trace ids, flight
records, the prom surface); this module makes that telemetry *verify*
something.  The
consistency contract the serving layer owes its clients is
replication-aware: per-document **session guarantees** over a convergent
CRDT ("Replication-Aware Linearizability", PAPERS.md) —

- **read-your-writes** — a read issued after an acked write must
  reflect it.  Correlated end to end: the write's ``trace_id`` (minted
  at admission) appears in exactly one flight ``CommitRecord``, which
  carries the ``snapshot_seq`` + ``fingerprint`` the commit published;
  any same-session read AFTER the ack must serve a snapshot at or past
  that seq (reads learn their snapshot from the ``X-Commit-Seq`` /
  ``X-Snapshot-Fingerprint`` response headers).
- **monotonic reads** — within a session, the served snapshot seq
  never regresses, and two reads at the same seq carry the same
  fingerprint (no forked snapshots).
- **dropped acks** — an acked write whose trace id never lands in any
  commit record by quiescence was acknowledged but not durably
  committed.
- **convergence** — after quiescence, every session's final read of a
  document observes the same (seq, fingerprint).

The oracle is *online*: events stream in from many session threads and
the scheduler's flight-record listener, and each check fires the
moment its evidence is complete — a read observed before its write's
commit record arrives is parked and re-checked on resolution, never
dropped.  Violations are first-class observability events: counted per
check (the ``crdt_oracle_*`` prom families, rendered when an oracle is
attached to the engine), kept as bounded structured details, and —
when a flight recorder is attached — dumped to JSONL under the new
``oracle`` reason so the ring's last N commits land on disk next to
the violation that condemned them.

Fault injection (``GRAFT_ORACLE_FAULT``) deliberately breaks the
serving path so CI can prove the oracle catches real violations
instead of vacuously passing:

- ``stale`` — one read serves the document's PREVIOUS published
  snapshot (a read-your-writes violation for any session that acked a
  write into the newer one);
- ``regress`` — one read serves the previous snapshot after the
  current one has already been observed (a monotonic-read violation);
- ``drop`` — one commit resolves its tickets as accepted but skips
  snapshot publish AND the flight record (a dropped ack).

Each armed fault fires exactly once per engine.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import flight as flight_mod

# the check names — the label set of crdt_oracle_checks_total /
# crdt_oracle_violations_total (stable: dashboards key on these)
CHECK_RYW = "read_your_writes"
CHECK_MONO = "monotonic_read"
CHECK_DROPPED = "dropped_ack"
CHECK_CONV = "convergence"
CHECK_FP = "fingerprint_match"
CHECKS = (CHECK_RYW, CHECK_MONO, CHECK_DROPPED, CHECK_CONV, CHECK_FP)


class FaultInjector:
    """One-shot serving-path faults, armed from ``GRAFT_ORACLE_FAULT``
    (comma-separated kinds) or explicitly in tests.  Each armed kind
    fires exactly once — :meth:`pop` is an atomic take."""

    KINDS = ("stale", "regress", "drop")

    def __init__(self, kinds=()):  # type: (tuple) -> None
        self._lock = threading.Lock()
        self._armed = {k: True for k in kinds if k in self.KINDS}
        # regress lets ONE eligible read pass first (it must serve the
        # current snapshot before the regression, or the fault
        # degenerates into stale and trips the wrong check)
        self._skips = {k: (1 if k == "regress" else 0)
                       for k in self._armed}
        self.fired: Dict[str, int] = {}

    @classmethod
    def from_env(cls) -> Optional["FaultInjector"]:
        raw = os.environ.get("GRAFT_ORACLE_FAULT", "").strip()
        if not raw:
            return None
        kinds = tuple(k.strip() for k in raw.split(",") if k.strip())
        inj = cls(kinds)
        return inj if inj._armed else None

    def armed(self, kind: str) -> bool:
        with self._lock:
            return self._armed.get(kind, False)

    def pop(self, kind: str) -> bool:
        """Take the fault if armed (it will not fire again).  A kind
        with pending skips burns one skip instead of firing."""
        with self._lock:
            if not self._armed.get(kind, False):
                return False
            if self._skips.get(kind, 0) > 0:
                self._skips[kind] -= 1
                return False
            self._armed[kind] = False
            self.fired[kind] = self.fired.get(kind, 0) + 1
            return True


class _SessionDocState:
    """Per-(session, document) oracle state."""

    __slots__ = ("min_seq", "pending", "last_seq", "last_fp", "reads")

    def __init__(self):
        # floor every later read must meet: max resolved commit seq of
        # this session's acked writes on this document
        self.min_seq = 0
        # acked writes awaiting their commit record:
        # trace_id -> first read seq observed AFTER the ack (or None)
        self.pending: Dict[str, Optional[int]] = {}
        self.last_seq: Optional[int] = None
        self.last_fp: Optional[str] = None
        self.reads = 0


class SessionOracle:
    """Thread-safe online checker.  Session threads feed
    :meth:`observe_write_ack` / :meth:`observe_read`; the flight
    recorder's listener (or a ``/debug/flight`` poll) feeds
    :meth:`ingest_commit_record`; :meth:`finalize` runs the
    quiescence-only checks (dropped acks, convergence)."""

    def __init__(self, flight: Optional[flight_mod.FlightRecorder] = None,
                 max_violation_details: int = 256,
                 on_violation: Optional[Callable[[Dict], None]] = None,
                 max_resolved_traces: int = 200_000,
                 max_fp_entries: int = 100_000,
                 max_session_states: int = 100_000):
        self._lock = threading.Lock()
        self._flight = flight
        self._on_violation = on_violation
        self._max_details = max_violation_details
        # history is bounded (FIFO): an oracle attached to a
        # long-running engine must not grow with total commits or
        # session churn.  An evicted resolved trace can only cost a
        # late duplicate ack a min_seq bump (it parks and resolves as
        # pending instead); an evicted (doc, seq) only narrows the
        # forked-snapshot window; an evicted idle session state only
        # resets that session's monotonicity floor (pending-free
        # states evict first, so dropped_ack evidence survives)
        self._max_resolved = max_resolved_traces
        self._max_fp = max_fp_entries
        self._max_session_states = max_session_states
        self._sessions: Dict[Tuple[str, str], _SessionDocState] = {}
        # bounded dedup window + monotonic count of distinct sessions
        self._session_ids: Dict[str, None] = {}
        self._sessions_seen = 0
        # running total of unresolved acked writes, so stats() on the
        # scrape path is O(1), not an all-states scan under the lock
        self._pending_total = 0
        # trace_id -> (doc_id, snapshot_seq, fingerprint)
        self._trace_commits: Dict[str, Tuple[str, int, Optional[str]]] = {}
        # trace_id -> [(session, doc_id), ...] for acked-but-unresolved
        # writes (so record ingestion on the scheduler thread is
        # O(members), not O(sessions)).  A LIST because the HTTP layer
        # adopts any well-formed client trace id — two sessions reusing
        # one id must both resolve, not silently shadow each other
        self._ack_owner: Dict[str, List[Tuple[str, str]]] = {}
        # (doc_id, seq) -> fingerprint, for the forked-snapshot check
        self._fp_by_seq: Dict[Tuple[str, int], str] = {}
        # final quiescent reads: doc_id -> {session: (seq, fp)}
        self._final: Dict[str, Dict[str, Tuple[int, Optional[str]]]] = {}
        # fleet convergence evidence: doc_id -> {replica:
        # state_fingerprint} — the replica-INDEPENDENT fingerprints
        # (serve/snapshot.py state_fingerprint, X-State-Fingerprint)
        # each server's quiescent snapshot reported; finalize()
        # checks every replica of a document agrees
        self._replica_states: Dict[str, Dict[str, str]] = {}
        self.checks: Dict[str, int] = {k: 0 for k in CHECKS}
        self.violation_counts: Dict[str, int] = {k: 0 for k in CHECKS}
        self.violations: List[Dict[str, Any]] = []
        self.commits_ingested = 0
        self.max_coalesce_width = 0
        self._finalized = False

    # -- violation plumbing ----------------------------------------------

    def _violate(self, check: str, session: str, doc_id: str,
                 **detail) -> None:
        """Requires ``self._lock``.  Count, keep bounded detail, and
        (outside the lock, via the caller's deferred list) fire the
        dump + hook."""
        self.violation_counts[check] += 1
        v = {"check": check, "session": session, "doc_id": doc_id,
             "at": time.time(), **detail}
        if len(self.violations) < self._max_details:
            self.violations.append(v)
        self._deferred.append(v)

    def _enter(self):
        """Lock and reset the deferred-violation list (the dump/hook
        must run OUTSIDE the oracle lock: the flight recorder takes its
        own lock, and a user hook may re-enter the oracle)."""
        self._lock.acquire()
        self._deferred: List[Dict[str, Any]] = []

    def _exit(self) -> None:
        deferred, self._deferred = self._deferred, []
        self._lock.release()
        for v in deferred:
            if self._flight is not None:
                try:
                    self._flight.dump(flight_mod.REASON_ORACLE)
                except Exception:   # noqa: BLE001 — oracle must not
                    pass            # take down the session it checks
            if self._on_violation is not None:
                try:
                    self._on_violation(v)
                except Exception:   # noqa: BLE001
                    pass

    def _state(self, session: str, doc_id: str) -> _SessionDocState:
        if session not in self._session_ids:
            self._session_ids[session] = None
            self._sessions_seen += 1
            while len(self._session_ids) > self._max_session_states:
                self._session_ids.pop(next(iter(self._session_ids)))
        key = (session, doc_id)
        st = self._sessions.get(key)
        if st is None:
            st = self._sessions[key] = _SessionDocState()
            if len(self._sessions) > self._max_session_states:
                # evict one state, oldest pending-free first (keeps
                # dropped_ack evidence as long as possible)
                for k in self._sessions:
                    if k != key and not self._sessions[k].pending:
                        del self._sessions[k]
                        break
                else:
                    victim = next(iter(self._sessions))
                    self._pending_total -= len(
                        self._sessions.pop(victim).pending)
        return st

    # -- event stream ----------------------------------------------------

    def observe_write_ack(self, session: str, doc_id: str,
                          trace_id: str) -> None:
        """An acked write (``accepted: true`` came back).  Rejected or
        shed writes must NOT be reported — the guarantee covers only
        writes the server acknowledged."""
        self._enter()
        try:
            st = self._state(session, doc_id)
            resolved = self._trace_commits.get(trace_id)
            if resolved is not None and resolved[0] == doc_id:
                # the commit record beat the ack back (both orders are
                # legal: the record lands right after publish, the ack
                # right after resolution).  Same-id-different-doc is a
                # client id collision, NOT a resolution — park it
                st.min_seq = max(st.min_seq, resolved[1])
            else:
                if trace_id not in st.pending:
                    st.pending[trace_id] = None
                    self._pending_total += 1
                self._ack_owner.setdefault(trace_id, []).append(
                    (session, doc_id))
        finally:
            self._exit()

    def observe_read(self, session: str, doc_id: str, seq: int,
                     fingerprint: Optional[str] = None) -> None:
        """A completed same-session read: the served snapshot's seq +
        fingerprint (the ``X-Commit-Seq`` / ``X-Snapshot-Fingerprint``
        response headers)."""
        self._enter()
        try:
            st = self._state(session, doc_id)
            st.reads += 1
            # monotonic reads: seq never regresses; same seq, same fp
            self.checks[CHECK_MONO] += 1
            if st.last_seq is not None:
                if seq < st.last_seq:
                    self._violate(CHECK_MONO, session, doc_id,
                                  seq=seq, prev_seq=st.last_seq,
                                  fingerprint=fingerprint)
                elif (seq == st.last_seq and fingerprint and st.last_fp
                        and fingerprint != st.last_fp):
                    self._violate(CHECK_MONO, session, doc_id,
                                  seq=seq, fingerprint=fingerprint,
                                  prev_fingerprint=st.last_fp)
            # a fingerprint only describes the snapshot it came with:
            # keep the previous one across a fingerprint-less read ONLY
            # while the seq is unchanged (carrying it across a seq
            # advance would condemn the NEXT fingerprinted read at the
            # new seq as a forked snapshot)
            if fingerprint:
                st.last_fp = fingerprint
            elif seq != st.last_seq:
                st.last_fp = None
            st.last_seq = seq
            # read-your-writes against already-resolved writes
            self.checks[CHECK_RYW] += 1
            if seq < st.min_seq:
                self._violate(CHECK_RYW, session, doc_id, seq=seq,
                              required_seq=st.min_seq,
                              fingerprint=fingerprint)
            # park this read against still-unresolved acked writes:
            # the FIRST read after each ack is the binding one (later
            # reads are covered by monotonicity)
            for tid, first in st.pending.items():
                if first is None:
                    st.pending[tid] = seq
            # forked-snapshot cross-check against the flight stream
            if fingerprint:
                self.checks[CHECK_FP] += 1
                known = self._fp_by_seq.get((doc_id, seq))
                if known is not None and known != fingerprint:
                    self._violate(CHECK_FP, session, doc_id, seq=seq,
                                  fingerprint=fingerprint,
                                  flight_fingerprint=known)
        finally:
            self._exit()

    def observe_final_read(self, session: str, doc_id: str, seq: int,
                           fingerprint: Optional[str] = None) -> None:
        """A quiescent final read (no writes in flight anywhere):
        feeds the convergence check in :meth:`finalize`, and counts as
        a normal read for the session guarantees."""
        self.observe_read(session, doc_id, seq, fingerprint)
        with self._lock:
            self._final.setdefault(doc_id, {})[session] = (
                seq, fingerprint)

    def observe_replica_state(self, doc_id: str, replica: str,
                              state_fp: str) -> None:
        """One fleet replica's quiescent state fingerprint for a
        document (the ``X-State-Fingerprint`` of its final read —
        replica-independent by construction, so every server of a
        converged fleet reports the SAME value).  Feeds the
        cross-replica convergence check in :meth:`finalize` — the
        check the single-server oracle always had, finally biting on
        more than one server."""
        with self._lock:
            self._replica_states.setdefault(doc_id, {})[replica] = \
                state_fp

    def ingest_commit_record(self, rec: Dict[str, Any]) -> None:
        """One flight ``CommitRecord`` (as a JSON dict — from the
        recorder's listener hook or a ``/debug/flight`` scrape).
        Resolves trace ids to the (seq, fingerprint) their commit
        published and re-checks any parked reads."""
        outcome = rec.get("outcome")
        if outcome not in ("committed", "partial", "noop", "rejected"):
            return
        doc_id = rec.get("doc_id")
        seq = rec.get("snapshot_seq")
        fp = rec.get("fingerprint")
        if doc_id is None:
            return
        if outcome in ("noop", "rejected") or seq is None:
            # an empty delta is acked (accepted, nothing to merge) and
            # its trace id lands on a "noop"/"rejected" record that
            # publishes no snapshot: resolve the pending ack with NO
            # read floor (an empty write obliges no read), or
            # finalize() would condemn a correct run as dropped_ack
            with self._lock:
                for tid in rec.get("trace_ids") or ():
                    if tid not in self._trace_commits:
                        self._remember_trace(tid, doc_id, 0, None)
                    for sess in self._take_owners(tid, doc_id):
                        st = self._sessions.get((sess, doc_id))
                        if st is not None and tid in st.pending:
                            st.pending.pop(tid)
                            self._pending_total -= 1
            return
        self._enter()
        try:
            self.commits_ingested += 1
            self.max_coalesce_width = max(
                self.max_coalesce_width, rec.get("coalesce_width") or 0)
            if fp:
                known = self._fp_by_seq.setdefault((doc_id, seq), fp)
                if known != fp:
                    self.checks[CHECK_FP] += 1
                    self._violate(CHECK_FP, "-", doc_id, seq=seq,
                                  fingerprint=fp,
                                  flight_fingerprint=known)
                while len(self._fp_by_seq) > self._max_fp:
                    self._fp_by_seq.pop(next(iter(self._fp_by_seq)))
            for tid in rec.get("trace_ids") or ():
                self._remember_trace(tid, doc_id, seq, fp)
                # resolve every session that acked this write on this
                # doc (if the ack has been registered yet — otherwise
                # observe_write_ack finds it in _trace_commits)
                for sess in self._take_owners(tid, doc_id):
                    st = self._sessions.get((sess, doc_id))
                    if st is None or tid not in st.pending:
                        continue
                    first_read = st.pending.pop(tid)
                    self._pending_total -= 1
                    st.min_seq = max(st.min_seq, seq)
                    self.checks[CHECK_RYW] += 1
                    if first_read is not None and first_read < seq:
                        self._violate(CHECK_RYW, sess, doc_id,
                                      seq=first_read, required_seq=seq,
                                      trace_id=tid)
        finally:
            self._exit()

    def _remember_trace(self, tid: str, doc_id: str, seq: int,
                        fp: Optional[str]) -> None:
        """Requires ``self._lock``.  Record a trace resolution with
        FIFO eviction at the bound."""
        self._trace_commits[tid] = (doc_id, seq, fp)
        while len(self._trace_commits) > self._max_resolved:
            self._trace_commits.pop(next(iter(self._trace_commits)))

    def _take_owners(self, tid: str, doc_id: str) -> List[str]:
        """Requires ``self._lock``.  Pop and return the sessions whose
        ack of ``tid`` belongs to ``doc_id``; owners of a colliding id
        on OTHER docs stay registered."""
        owners = self._ack_owner.get(tid)
        if not owners:
            return []
        mine = [sess for sess, d in owners if d == doc_id]
        rest = [(sess, d) for sess, d in owners if d != doc_id]
        if rest:
            self._ack_owner[tid] = rest
        else:
            self._ack_owner.pop(tid, None)
        return mine

    # -- quiescence checks ------------------------------------------------

    def finalize(self) -> List[Dict[str, Any]]:
        """Run the checks that only make sense at quiescence (call
        after the load stops and ``ServingEngine.flush()`` returned):
        every acked write resolved to a commit record, and all
        sessions' final reads of a document agree.  Returns the full
        bounded violation-detail list.  Idempotent per oracle."""
        self._enter()
        try:
            if not self._finalized:
                self._finalized = True
                for (sess, doc_id), st in sorted(self._sessions.items()):
                    self.checks[CHECK_DROPPED] += 1
                    for tid in sorted(st.pending):
                        self._violate(CHECK_DROPPED, sess, doc_id,
                                      trace_id=tid)
                for doc_id, by_sess in sorted(self._final.items()):
                    self.checks[CHECK_CONV] += 1
                    distinct = {v for v in by_sess.values()}
                    if len(distinct) > 1:
                        self._violate(
                            CHECK_CONV, "-", doc_id,
                            observed=sorted(
                                (s, v[0], v[1])
                                for s, v in by_sess.items())[:16])
                # fleet convergence: every replica's quiescent state
                # fingerprint of a document must agree (the
                # fingerprints are replica-independent, so any
                # disagreement is real divergence, not a seq skew)
                for doc_id, by_rep in sorted(
                        self._replica_states.items()):
                    self.checks[CHECK_CONV] += 1
                    if len(set(by_rep.values())) > 1:
                        self._violate(
                            CHECK_CONV, "-", doc_id,
                            replicas=sorted(by_rep.items())[:16])
            return list(self.violations)
        finally:
            self._exit()

    # -- exposition --------------------------------------------------------

    def violations_total(self) -> int:
        with self._lock:
            return sum(self.violation_counts.values())

    def pending_writes(self) -> int:
        with self._lock:
            return self._pending_total

    def stats(self) -> Dict[str, Any]:
        """Counter/gauge view (prom families + loadgen report)."""
        with self._lock:
            return {
                "sessions": self._sessions_seen,
                "checks": dict(self.checks),
                "violations": dict(self.violation_counts),
                "violations_total": sum(self.violation_counts.values()),
                "pending_writes": self._pending_total,
                "commits_ingested": self.commits_ingested,
                "max_coalesce_width": self.max_coalesce_width,
            }

    # -- engine attachment -------------------------------------------------

    def attach_engine(self, engine) -> None:
        """Wire this oracle to a :class:`ServingEngine`: subscribe to
        its flight recorder's record stream (commit records resolve
        trace ids with no polling) and register for the engine's
        ``crdt_oracle_*`` prom families."""
        self._flight = engine.flight
        engine.oracle = self
        engine.flight.add_listener(self.ingest_commit_record)

    def detach_engine(self, engine) -> None:
        engine.flight.remove_listener(self.ingest_commit_record)
        if getattr(engine, "oracle", None) is self:
            engine.oracle = None
