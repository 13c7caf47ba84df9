"""Fleet-wide causal tracing: the per-node span registry + the wire
helpers that let one write's trace id survive every process boundary
(docs/OBSERVABILITY.md §Fleet tracing & visibility ledger).

The single-node path already attributes a commit end-to-end (flight
recorder, stage breakdown), but a fleet write crosses processes —
gateway forward, mergetier ``POST /merge``, anti-entropy windows,
watch delivery — and a node-local trace dies at the first boundary.  This
module is the cross-process half:

- every hop appends a **span** ``{node, kind, t_rel_ms, t_wall}`` to
  the local :class:`FleetTrace` ring under the write's trace id;
- ``X-Span-Ctx`` (:data:`~.trace.SPAN_CTX_HEADER`) carries
  ``node;kind;send_ts_ms`` on forwarded/offloaded requests so the
  receiver can name its upstream and bound the transport leg;
- ``X-Trace-Frontier`` (:data:`~.trace.TRACE_FRONTIER_HEADER`) rides
  windowed ``/ops`` responses — ``send_ts_ms;tid,tid,...`` — so the
  anti-entropy PULLER can stamp visible-at-replica spans for the
  commits the window carried without a new RPC;
- ``GET /debug/trace/{id}`` on any node returns the local spans and
  federates ONE bounded fetch to peers named in them
  (cluster/gateway.py ``debug_trace``), assembling the causal tree.

Clock honesty: ``t_rel_ms`` is relative to the trace's first local
span (one clock — a truth); ``t_wall`` crosses nodes only for display
ordering and one-way deltas derived from it are BOUNDS, never truths
(the skew caveat in docs/OBSERVABILITY.md).

Memory: both rings are FIFO-bounded — at most
``GRAFT_FLEETTRACE_MAX_TRACES`` traces, each holding at most
``GRAFT_FLEETTRACE_MAX_SPANS`` spans — so span state never grows with
commit count.  ``GRAFT_FLEETTRACE=0`` disables the tier: no registry
writes, and every caller gates its wire header on :func:`enabled`, so
the wire carries none of its headers.
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from ..utils.hostenv import env_int as _env_int

DEFAULT_MAX_TRACES = 512
DEFAULT_MAX_SPANS = 64
_FRONTIER_DOCS = 256
_FRONTIER_TIDS = 8

# the five hop kinds a fully-replicated watched write crosses (plus
# the cross-process attribution kinds) — label vocabulary for
# crdt_fleettrace_spans_total{kind}
SPAN_KINDS = ("admission", "forward", "fsync", "publish",
              "remote_merge", "ae_apply", "watch_delivery", "canary")


def enabled() -> bool:
    """Whether the fleet-tracing tier is on (``GRAFT_FLEETTRACE``,
    default ON; ``=0`` drops every wire header and span cost).  Read
    per call — tests toggle it."""
    return os.environ.get("GRAFT_FLEETTRACE", "1").strip() \
        not in ("", "0")


# -- wire helpers (header values; both directions tolerate garbage) -------


def encode_span_ctx(node: str, kind: str,
                    send_ts_ms: Optional[int] = None) -> str:
    """``X-Span-Ctx`` value: ``node;kind;send_ts_ms`` — who is calling,
    why, and when by the sender's clock."""
    if send_ts_ms is None:
        send_ts_ms = int(time.time() * 1e3)
    return f"{node};{kind};{send_ts_ms}"


def parse_span_ctx(text: Optional[str]) \
        -> Optional[Tuple[str, str, int]]:
    """Parse an ``X-Span-Ctx`` value; ``None`` on anything malformed
    (a bad header is ignored, never an error — tracing must not be
    able to fail a write)."""
    if not text:
        return None
    parts = text.split(";")
    if len(parts) != 3 or not parts[0] or not parts[1]:
        return None
    try:
        return parts[0], parts[1], int(parts[2])
    except ValueError:
        return None


def encode_frontier(send_ts_ms: int, trace_ids: List[str]) -> str:
    """``X-Trace-Frontier`` value: ``send_ts_ms;tid,tid,...`` — the
    trace ids of the recent commits an ``/ops`` window carries, plus
    the serving node's send timestamp for the skew-bounded
    visible-at-replica stamp."""
    return f"{send_ts_ms};{','.join(trace_ids)}"


def parse_frontier(text: Optional[str]) \
        -> Optional[Tuple[int, List[str]]]:
    if not text or ";" not in text:
        return None
    ts_part, _, tid_part = text.partition(";")
    try:
        send_ts_ms = int(ts_part)
    except ValueError:
        return None
    tids = [t for t in tid_part.split(",") if t]
    return send_ts_ms, tids


class FleetTrace:
    """Per-node span registry: trace id → FIFO-bounded span ring.

    One instance per :class:`~crdt_graph_tpu_torch.cluster.gateway.
    ClusterNode` (in-process fleets share a process, so like the
    flight recorder this is NOT process-global).  Thread-safe; every
    hop on this node calls :meth:`record`.
    """

    def __init__(self, node_name: str,
                 max_traces: Optional[int] = None,
                 max_spans: Optional[int] = None):
        self.node = node_name
        if max_traces is None:
            max_traces = _env_int("GRAFT_FLEETTRACE_MAX_TRACES",
                                  DEFAULT_MAX_TRACES)
        if max_spans is None:
            max_spans = _env_int("GRAFT_FLEETTRACE_MAX_SPANS",
                                 DEFAULT_MAX_SPANS)
        self.max_traces = max(1, max_traces)
        self.max_spans = max(1, max_spans)
        self._lock = threading.Lock()
        # trace id -> (t0_wall, t0_mono, deque of spans)
        self._traces: "OrderedDict[str, Tuple[float, float, deque]]" \
            = OrderedDict()
        self.spans_by_kind: Dict[str, int] = {}
        self.evicted_traces = 0
        self.federated_fetches = 0
        # per-doc trace frontier: the trace ids of the most recent
        # commits, stamped onto windowed /ops responses so the
        # anti-entropy puller can attribute what a window carried
        # (bounded: ≤ _FRONTIER_DOCS docs × _FRONTIER_TIDS ids)
        self._frontier: "OrderedDict[str, deque]" = OrderedDict()

    def record(self, trace_id: Optional[str], kind: str,
               **extra) -> None:
        """Append one span under ``trace_id``.  ``t_rel_ms`` is
        relative to this trace's first span ON THIS NODE (single
        clock); extras (``peer``, ``ms``, ``seq``, ...) ride along.
        No-op on an empty id or when the tier is disabled."""
        if not trace_id or not enabled():
            return
        now_wall = time.time()
        now_mono = time.perf_counter()
        with self._lock:
            ent = self._traces.get(trace_id)
            if ent is None:
                ent = (now_wall, now_mono,
                       deque(maxlen=self.max_spans))
                self._traces[trace_id] = ent
                while len(self._traces) > self.max_traces:
                    self._traces.popitem(last=False)
                    self.evicted_traces += 1
            else:
                # keep the ring FIFO by trace *creation*: touching an
                # old trace must not let it outlive newer ones forever
                pass
            span = {"node": self.node, "kind": kind,
                    "t_rel_ms": round((now_mono - ent[1]) * 1e3, 3),
                    "t_wall": round(now_wall, 6)}
            for k, v in extra.items():
                if v is not None:
                    span[k] = v
            ent[2].append(span)
            self.spans_by_kind[kind] = \
                self.spans_by_kind.get(kind, 0) + 1

    def note_commit(self, doc_id: str,
                    trace_ids: Tuple[str, ...]) -> None:
        """Fold a commit's trace ids into the doc's frontier ring
        (called from the same ``record_commit`` seam as the spans)."""
        if not trace_ids or not enabled():
            return
        with self._lock:
            ring = self._frontier.get(doc_id)
            if ring is None:
                ring = self._frontier[doc_id] = \
                    deque(maxlen=_FRONTIER_TIDS)
                while len(self._frontier) > _FRONTIER_DOCS:
                    self._frontier.popitem(last=False)
            for tid in trace_ids:
                ring.append(tid)

    def frontier_header(self, doc_id: str) -> Optional[str]:
        """The ``X-Trace-Frontier`` value for a windowed ``/ops``
        response on ``doc_id`` — None when there is nothing to say
        (no commits traced here, or the tier is off)."""
        if not enabled():
            return None
        with self._lock:
            ring = self._frontier.get(doc_id)
            tids = list(ring) if ring else []
        if not tids:
            return None
        return encode_frontier(int(time.time() * 1e3), tids)

    def spans(self, trace_id: str) -> List[Dict]:
        """The local spans for one trace, oldest first (copy)."""
        with self._lock:
            ent = self._traces.get(trace_id)
            return [dict(s) for s in ent[2]] if ent else []

    def known_nodes(self, trace_id: str) -> List[str]:
        """Node names appearing in this trace's local spans (either as
        the recording node or as a named peer) — the federation
        candidates for ``/debug/trace/{id}``."""
        names = []
        for s in self.spans(trace_id):
            for key in ("node", "peer", "worker"):
                v = s.get(key)
                if v and v not in names:
                    names.append(v)
        return names

    def trace_count(self) -> int:
        with self._lock:
            return len(self._traces)

    def stats(self) -> Dict:
        with self._lock:
            return {"node": self.node,
                    "traces": len(self._traces),
                    "max_traces": self.max_traces,
                    "max_spans": self.max_spans,
                    "spans_by_kind": dict(self.spans_by_kind),
                    "evicted_traces": self.evicted_traces,
                    "federated_fetches": self.federated_fetches,
                    "frontier_docs": len(self._frontier)}
