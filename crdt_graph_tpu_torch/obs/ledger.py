"""The write-to-visibility ledger: when did each commit become real,
durable, replicated, and delivered (docs/OBSERVABILITY.md §Fleet
tracing & visibility ledger).

Per fleet node, a FIFO-bounded per-document ring keyed by commit seq
records the stages a write crosses on its way to global visibility:

- **ack** — the commit published at the primary (``record_commit``,
  the same seam that feeds the flight recorder);
- **durable** — the WAL fsync offset inside the commit, from the
  commit's own stage breakdown (``wal_append`` + ``wal_fsync``);
- **delivered** — the first watch delivery of the generation
  (``serve.watch.delivery_headers`` stamps it: threaded and reactor
  egress share that one builder, so both paths are covered).  The
  scheduler resolves a commit's tickets before it stamps the ack, so
  a watcher can be handed the generation first: such an early
  delivery is held (bounded, :data:`EARLY_MAX`) and stamped, at zero
  lag, by the ack that follows;
- **visible-at-replica** — stamped on the PULLING node when an
  anti-entropy window applies: the window's ``X-Trace-Frontier``
  carries the primary's send timestamp, and the one-way delta
  ``now - send_ts`` crosses two clocks, so it is recorded and
  exported as a BOUND on visibility lag, never a truth (the skew
  caveat; docs/OBSERVABILITY.md).

Exposition: ``crdt_visibility_lag_seconds{stage,peer}`` histograms
(obs/prom.py ``render_cluster`` — absent on non-fleet engines) and a
``GET /debug/visibility/{doc}`` JSON tail.  Bounded everywhere: at
most ``GRAFT_VISIBILITY_DOCS`` documents of ``GRAFT_VISIBILITY_RING``
entries, plus one small remote-apply ring.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from ..serve.metrics import Histogram
from ..utils.hostenv import env_int as _env_int

DEFAULT_RING = 256
DEFAULT_DOCS = 64
DEFAULT_REMOTE_RING = 128
# watch deliveries held until their commit's ack is stamped
EARLY_MAX = 256

# visibility lag in SECONDS: sub-ms local stages up through the
# multi-second anti-entropy cadence
LAG_BOUNDS_S = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

STAGES = ("durable", "publish", "watch", "replica")


class VisibilityLedger:
    """One per fleet node (cluster/gateway.py wires it onto the
    engine); thread-safe — scheduler, watch egress, and anti-entropy
    threads all stamp it."""

    def __init__(self, node_name: str,
                 ring: Optional[int] = None,
                 max_docs: Optional[int] = None):
        self.node = node_name
        if ring is None:
            ring = _env_int("GRAFT_VISIBILITY_RING", DEFAULT_RING)
        if max_docs is None:
            max_docs = _env_int("GRAFT_VISIBILITY_DOCS", DEFAULT_DOCS)
        self.ring = max(1, ring)
        self.max_docs = max(1, max_docs)
        self._lock = threading.Lock()
        # doc -> deque of entries (dicts keyed by commit seq)
        self._docs: "OrderedDict[str, deque]" = OrderedDict()
        # frontier applies observed on THIS node as the puller:
        # (doc, peer, trace_ids, bound_s, t_wall)
        self._remote: deque = deque(maxlen=DEFAULT_REMOTE_RING)
        self._hists: Dict[Tuple[str, str], Histogram] = {}
        # (doc, seq) of watch deliveries that beat the commit's ack
        self._early: "OrderedDict[Tuple[str, int], None]" = OrderedDict()
        self.commits = 0
        self.watch_stamped = 0
        self.replica_applies = 0
        self.skew_clamped = 0

    def _observe(self, stage: str, peer: str, lag_s: float) -> None:
        key = (stage, peer)
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = Histogram(LAG_BOUNDS_S)
        h.observe(lag_s)

    # -- stamps (each inter-node path calls exactly one) ------------------

    def record_commit(self, doc_id: str, seq: int,
                      trace_ids: Tuple[str, ...],
                      durable_ms: Optional[float],
                      publish_ms: float) -> Optional[List[str]]:
        """Ack-at-primary: called from ``ServingEngine.record_commit``
        — the single seam every commit already crosses.  Where a watch
        already delivered this generation, the entry is stamped
        delivered at zero lag and its trace ids are returned (the
        caller registers their ``watch_delivery`` spans); else None."""
        now_wall = time.time()
        now_mono = time.perf_counter()
        entry = {"seq": seq, "trace_ids": list(trace_ids),
                 "t_ack_wall": round(now_wall, 6),
                 "_t_ack_mono": now_mono,
                 "durable_ms": durable_ms,
                 "publish_ms": round(publish_ms, 3),
                 "watch_ms": None}
        with self._lock:
            ring = self._docs.get(doc_id)
            if ring is None:
                ring = self._docs[doc_id] = deque(maxlen=self.ring)
                while len(self._docs) > self.max_docs:
                    self._docs.popitem(last=False)
            ring.append(entry)
            self.commits += 1
            if durable_ms is not None:
                self._observe("durable", "", durable_ms / 1e3)
            self._observe("publish", "", publish_ms / 1e3)
            if self._early.pop((doc_id, seq), False) is None:
                entry["watch_ms"] = 0.0
                self.watch_stamped += 1
                self._observe("watch", "", 0.0)
                return list(entry["trace_ids"])[:8]
        return None

    def note_watch_delivery(self, doc_id: str,
                            seq: int) -> Optional[List[str]]:
        """Delivered-to-watchers: first delivery of generation ``seq``
        (later deliveries of the same generation are the fan-out, not
        the visibility edge).  Returns the stamped entry's trace ids
        on the FIRST delivery — the caller uses them to register
        ``watch_delivery`` spans — and None otherwise."""
        now_mono = time.perf_counter()
        with self._lock:
            ring = self._docs.get(doc_id)
            for entry in reversed(ring or ()):
                if entry["seq"] == seq:
                    if entry["watch_ms"] is not None:
                        return None
                    entry["watch_ms"] = round(
                        (now_mono - entry["_t_ack_mono"]) * 1e3, 3)
                    self.watch_stamped += 1
                    self._observe("watch", "",
                                  entry["watch_ms"] / 1e3)
                    return list(entry["trace_ids"])[:8]
                if entry["seq"] < seq:
                    break
            if not ring or ring[-1]["seq"] < seq:
                # delivered before its ack was stamped: held for it
                self._early[(doc_id, seq)] = None
                while len(self._early) > EARLY_MAX:
                    self._early.popitem(last=False)
        return None

    def note_replica_apply(self, doc_id: str, peer: str,
                           send_ts_ms: int,
                           trace_ids: List[str]) -> None:
        """Visible-at-replica, stamped on the PULLING node when an
        anti-entropy window applies.  ``send_ts_ms`` is the SERVING
        peer's clock; the delta to our clock is a bound (clamped at
        zero — negative skew would otherwise report time travel)."""
        bound_s = time.time() - send_ts_ms / 1e3
        if bound_s < 0.0:
            bound_s = 0.0
            with self._lock:
                self.skew_clamped += 1
        with self._lock:
            self._remote.append(
                {"doc": doc_id, "peer": peer,
                 "trace_ids": list(trace_ids)[:8],
                 "bound_s": round(bound_s, 6),
                 "t_wall": round(time.time(), 6)})
            self.replica_applies += 1
            self._observe("replica", peer, bound_s)

    # -- exposition -------------------------------------------------------

    def tail(self, doc_id: str, n: int = 32) -> Dict:
        """The ``GET /debug/visibility/{doc}`` payload: this node's
        recent commit entries for the doc plus the recent frontier
        applies it pulled (replica view)."""
        with self._lock:
            ring = self._docs.get(doc_id)
            entries = [{k: v for k, v in e.items()
                        if not k.startswith("_")}
                       for e in list(ring)[-n:]] if ring else []
            remote = [dict(r) for r in list(self._remote)[-n:]
                      if r["doc"] == doc_id]
        return {"doc": doc_id, "node": self.node,
                "entries": entries, "remote_applies": remote,
                "skew_note": "cross-node lags are one-way bounds, "
                             "not truths (clock skew)"}

    def lag_export(self) -> List[Dict]:
        """Per-(stage, peer) histogram exports for prom rendering."""
        with self._lock:
            keys = sorted(self._hists)
            return [{"stage": st, "peer": peer,
                     "hist": self._hists[(st, peer)].export()}
                    for st, peer in keys]

    def stats(self) -> Dict:
        with self._lock:
            docs = len(self._docs)
            entries = sum(len(r) for r in self._docs.values())
        return {"node": self.node, "docs": docs, "entries": entries,
                "commits": self.commits,
                "watch_stamped": self.watch_stamped,
                "replica_applies": self.replica_applies,
                "skew_clamped": self.skew_clamped,
                "lag": self.lag_export()}
