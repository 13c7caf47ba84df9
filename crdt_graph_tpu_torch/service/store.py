"""Server-side document store: replicated trees keyed by document id.

The reference's deployment model (README.md:5-9, 20-22) needs two server
roles it leaves to the application: a coordinator that hands out unique
numeric replica ids, and a relay/merger that moves operation batches
between replicas.  ``DocumentStore`` is both, backed by the replica
engine: each document is one server replica that merges every client's
deltas (one merge on the card per bulk apply) and serves pull-based anti-entropy
(``operations_since``) to any client.

Observability counters (SURVEY §5 metrics row: ops merged, dedup hits,
rejected batches) are served alongside.

This is the LEGACY inline-merge store: one lock per document, held
across the kernel merge — reads of a document queue behind its merges,
and two documents' handler threads may merge on the card at once (each
launches on its own thread's current stream).
The wire service now defaults to :class:`crdt_graph_tpu_torch.serve.
ServingEngine` (same duck-typed surface: ``get``/``ids``/``encode_ops``/
``decode_ops``, documents exposing the read/write methods below), which
serves reads from published immutable snapshots and coalesces writes
through a merge scheduler (docs/SERVING.md).  ``Document`` remains the
simple embeddable single-threaded/locked container, and its
``apply``/``apply_body`` semantics are the reference behavior the
scheduler's sequential fallback preserves per request.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from .. import engine as engine_mod
from ..codec import json_codec
from ..core import operation as op_mod
from ..core.errors import CRDTError
from ..core.operation import Operation
# canonical definitions live with the serving engine (serve/engine.py);
# both write paths MUST agree — the replica-id scheme and the ingest
# crossover are wire-visible behavior, not per-store tuning
from ..serve.engine import SERVER_REPLICA, WIRE_FAST_BYTES

__all__ = ["Document", "DocumentStore", "SERVER_REPLICA"]


class Document:
    """One replicated document plus its merge counters."""

    def __init__(self, doc_id: str, max_depth: int = 16, device=None):
        self.doc_id = doc_id
        self.tree = engine_mod.init(SERVER_REPLICA, max_depth=max_depth,
                                    device=device)
        self.next_replica = 1
        self.ops_merged = 0
        self.dup_absorbed = 0
        self.batches_rejected = 0
        self.lock = threading.Lock()

    def assign_replica(self) -> int:
        with self.lock:
            rid = self.next_replica
            self.next_replica += 1
            return rid

    def apply(self, operation: Operation) -> Tuple[bool, Operation]:
        """Merge a client delta.  Returns (accepted, applied_ops).

        A rejected batch (causality gap / invalid path) leaves the document
        untouched — the client should sync and retry, the reference's
        recovery contract (CRDTree.elm:104-107)."""
        leaves = list(op_mod.iter_leaves(operation))
        with self.lock:
            return self._merge(lambda: self.tree.apply(operation),
                               len(leaves))

    # wire bodies at/above this take the column ingest path (native
    # parse, no per-op Python objects before the kernel) — shared with
    # the serving engine's parse crossover (class attr so tests can
    # monkeypatch the routing)
    WIRE_FAST_BYTES = WIRE_FAST_BYTES

    def apply_body(self, body,
                   trace_id: Optional[str] = None
                   ) -> Tuple[bool, Operation]:
        """Merge a raw wire body (``bytes`` as read off the socket, or
        ``str``; the threshold is in BYTES, so handlers should pass the
        undecoded body — ADVICE r4).  ``trace_id`` is accepted for
        write-path signature parity with ``ServedDoc.apply_body`` (the
        handler always passes one); the legacy inline store has no
        flight recorder, so it is ignored here.  Small deltas decode to op objects
        (sequence semantics, byte-for-byte the old path); bootstrap-size
        bodies stream through the native column ingest
        (engine.apply_wire) — the wire→objects→columns round trip
        dominated POST /ops at headline scale
        (scripts/bench_service_e2e.py)."""
        from .. import native
        if isinstance(body, str):
            body = body.encode()
        if len(body) < self.WIRE_FAST_BYTES or not native.available():
            return self.apply(DocumentStore.decode_ops(body))
        pnew = native.parse_pack(body, max_depth=self.tree._max_depth)
        with self.lock:
            return self._merge(lambda: self.tree.apply_packed(pnew),
                               pnew.num_ops)

    def _merge(self, run, n_leaves: int) -> Tuple[bool, Operation]:
        try:
            run()
        except CRDTError:
            self.batches_rejected += 1
            return False, op_mod.from_list([])
        applied = self.tree.last_operation
        n_applied = op_mod.count(applied)
        self.ops_merged += n_applied
        self.dup_absorbed += n_leaves - n_applied
        return True, applied

    def operations_since(self, ts: int) -> Operation:
        with self.lock:
            return self.tree.operations_since(ts)

    def dumps_since_bytes(self, ts: int) -> bytes:
        """Pre-encoded wire JSON for ``GET /ops`` — the bootstrap fast
        path (native column encoder, engine.TpuTree.dumps_since_bytes),
        written to the socket with no str round trip."""
        with self.lock:
            return self.tree.dumps_since_bytes(ts)

    def snapshot_packed(self) -> bytes:
        """Binary snapshot wire format: the packed-checkpoint npz bytes
        (engine.checkpoint_packed).  A client bootstraps a 1M-op doc
        from this in one transfer + ``restore_packed`` instead of
        replaying the JSON log, then catches up via ``/ops?since=``."""
        import io
        with self.lock:
            buf = io.BytesIO()
            # uncompressed: the lock is held while encoding, and zlib at
            # 1M ops costs seconds (scripts/bench_egress.py)
            self.tree.checkpoint_packed(buf, compress=False)
            return buf.getvalue()

    def snapshot(self) -> List[Any]:
        with self.lock:
            return self.tree.visible_values()

    def clock(self) -> Dict[str, int]:
        """The server's vector clock (replica id → last applied ts).

        Lets a client ask for exactly its missing suffix
        (``/ops?since=clock[my_replica]``) instead of replaying from 0 —
        the server-side face of the reference's ``lastReplicaTimestamp``
        (CRDTree.elm:637-639)."""
        with self.lock:
            return {str(r): ts for r, ts in self.tree._replicas.items()}

    def metrics(self) -> Dict[str, int]:
        with self.lock:
            return {
                "ops_merged": self.ops_merged,
                "dup_absorbed": self.dup_absorbed,
                "batches_rejected": self.batches_rejected,
                "num_visible": len(self.tree),
                "log_length": self.tree.log_length,
                "replicas_assigned": self.next_replica - 1,
            }


class DocumentStore:
    """All documents hosted by this server, merging on ``device`` (the
    card unless the caller names another; no card and no ``device=``
    raises)."""

    def __init__(self, max_depth: int = 16, device=None):
        from ..ops.merge import resolve_device
        self._docs: Dict[str, Document] = {}
        self._lock = threading.Lock()
        self._max_depth = max_depth
        self.device = resolve_device(device)

    def get(self, doc_id: str, create: bool = True) -> Optional[Document]:
        with self._lock:
            doc = self._docs.get(doc_id)
            if doc is None and create:
                doc = self._docs[doc_id] = Document(
                    doc_id, max_depth=self._max_depth,
                    device=self.device)
            return doc

    def ids(self) -> List[str]:
        with self._lock:
            return sorted(self._docs)

    # -- wire-format helpers ---------------------------------------------

    @staticmethod
    def encode_ops(op: Operation) -> str:
        return json_codec.dumps(op)

    @staticmethod
    def decode_ops(payload) -> Operation:
        """Wire JSON (str or bytes) → Operation."""
        return json_codec.loads(payload)
