"""The replica engine: an array-backed CRDTree on the card.

The port of the reference package's ``engine`` (``TpuTree``).  The
replica keeps its state the semilattice way — the state IS the operation
set, and the tree is a materialised view — and two materialisation paths
share that state, split by delta size:

- **Batched merge** (``ops.merge.materialize``) for large deltas —
  anti-entropy catch-up, bulk merges — on the replica's device: the card
  unless the caller names another.  The device is resolved once, at
  construction, and every bulk merge runs there; there is no quiet CPU
  fallback.
- **Host mirror** (``host_tree.HostTree``) for small deltas
  (``DELTA_THRESHOLD``) and every interactive read: the reference's own
  per-op application on mutable slot arrays, so a 1-op delta on an
  n-op document costs O(delta).  It runs on the host on every platform,
  exactly as in the reference; after a bulk merge the mirror is rebuilt
  from the ``NodeTable`` in one vectorised pass.

API parity: method names and semantics mirror the oracle ``CRDTree``
(``core.tree``) and the reference engine — local edits stamp
``replica_id * 2**32 + counter`` timestamps and move the cursor, remote
``apply`` does not, ``operations_since`` serves pull-based anti-entropy,
redelivery is absorbed, and a failing remote batch raises without
mutating state.  ``TpuTree`` is a MUTABLE container.

Durability is the reference's: the op log's cold tiers
(``enable_log_tiering``, spilled at commit boundaries), the tiered
checkpoint (``checkpoint_tiered`` → ``restore_tiered``, whose cold tiers
stay numpy on the host and page in lazily), the persisted
materialization ("matz", so a restored replica's first read is O(tail))
and the WAL (``wal.Wal``, replayed through
:meth:`TpuTree.apply_packed_chunked`).  Every on-disk format is
byte-identical to the reference's, so a durable directory written by
either package recovers in the other.  A restored
replica's first full merge (no matz, or a WAL tail past the bulk
crossover) runs on its device like any other bulk merge.

The wire paths (``apply_wire``, ``dumps_since_bytes``) take the native
codec (``native``) when it builds, else the reference's own pure-Python
paths.  The packed formats (the checkpoint npz and the anti-entropy
egress) are ``codec.packed``'s.  Every bulk merge
goes through the ops-axis route (``parallel.opsaxis.routed_materialize``):
with ``GRAFT_OPSAXIS=1`` on a host with two or more cards a large merge
is sharded across them with the same table; otherwise (the default, and
always on one card) the merge is the single-device ``materialize``,
which derives a vouched packing's slot hints on the device after the
copy (``ops.slot_hints``).  :func:`apply_packed_grouped` catches several
replicas up in one batched merge over a document axis
(``parallel.mesh``), the serving scheduler's cross-document round.
"""
from __future__ import annotations

import json
import os
import struct
import time
import zipfile
import zlib
from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .codec import json_codec
from .codec import packed as packed_mod
from .codec.packed import DEFAULT_MAX_DEPTH, PackedOps
from .core import operation as op_mod
from .core import timestamp as ts_mod
from .core.errors import (CheckpointError, CRDTError, InvalidPathError,
                          NotFound, OperationFailedError)
from .core.operation import Add, Batch, Delete, Operation
from .host_tree import NIL, HostTree
from .oplog import OpLog, PackedBatch, ViewSpanBatch
from .ops import merge as merge_mod
from .ops import view as view_mod
from .ops.merge import APPLIED, INVALID_PATH, NOT_FOUND, NodeTable
from .parallel import mesh as mesh_mod
from .parallel import opsaxis
from .utils import profiling

# deltas at or under this many leaves apply host-side in O(delta); larger
# ones re-materialise through the batched merge
DELTA_THRESHOLD = 256


class MatzWarning(UserWarning):
    """A persisted materialization artifact (``matz-*.npz``) was
    present but unusable — corrupt, truncated, or inconsistent with
    the restored log.  The restore FALLS BACK to the full first-merge
    materialization (slow but always correct) and warns with this
    type so operators can see cold paths silently losing their
    O(tail) guarantee.  Never affects data correctness."""


def matz_enabled() -> bool:
    """The ``GRAFT_MATZ`` kill switch (default on)."""
    return os.environ.get("GRAFT_MATZ", "1").strip() != "0"


def _mode(p: PackedOps) -> Optional[str]:
    """Merge hint mode for a packed batch: "exhaustive" when this
    engine's own ingest vouched for hint completeness (pack/concat
    provenance — auto and exhaustive are then semantically identical,
    and exhaustive runs neither the sort nor the join); the verified
    auto mode (None) otherwise, e.g. for a restored checkpoint whose
    hint columns were defaulted.

    A violated vouch silently mis-resolves references (that is the
    mode's contract), so ``GRAFT_DEBUG_VOUCH=1`` arms the reference's
    host-side tripwire: every vouched batch is re-audited before it
    reaches the exhaustive mode."""
    if not p.hints_vouched:
        return None
    if os.environ.get("GRAFT_DEBUG_VOUCH") and not packed_mod.verify_hints(p):
        raise RuntimeError(
            "hints_vouched batch failed the host hint audit — a "
            "producer (pack/concat/restore) broke the vouch "
            "invariant; the exhaustive mode would silently "
            "mis-resolve")
    return "exhaustive"


class StaleNodeView(RuntimeError):
    """A TableNode outlived the state it points into.

    Mirror slots are append-only, so views survive host-path edits; a
    bulk merge compacts and reassigns slots, and using a view across one
    would silently read a DIFFERENT node, so it fails loudly instead.
    Re-fetch with ``tree.get(node.path)``."""


class TableNode:
    """Read-only node view over the host mirror — the engine-side
    counterpart of the oracle ``Node`` facade: value, timestamp, path
    accessors and visible-children traversal, resolved from the mirror's
    slot arrays without any device round-trip.  A bulk merge invalidates
    views (see :class:`StaleNodeView`)."""

    __slots__ = ("_tree", "_slot", "_gen")

    def __init__(self, tree: "TpuTree", slot: int):
        self._tree = tree
        self._slot = slot
        self._gen = tree._generation

    def _check(self) -> None:
        if self._gen != self._tree._generation:
            raise StaleNodeView(
                "node view predates the last bulk merge; re-fetch it "
                "with tree.get(path)")

    def _mirror(self) -> HostTree:
        self._check()
        return self._tree._ensure_mirror()

    @property
    def timestamp(self) -> int:
        m = self._mirror()
        if self.is_root or self._slot < 0:
            return 0
        return int(m.ts[self._slot])

    @property
    def path(self) -> Tuple[int, ...]:
        if self._slot < 0:
            # the one shared branch-head sentinel answers () wherever it
            # was reached (oracle parity, core/node.py sentinel)
            return ()
        return self._mirror().path_of(self._slot)

    @property
    def is_root(self) -> bool:
        return self._slot == 0

    @property
    def is_deleted(self) -> bool:
        """Tombstoned directly OR gone with a deleted ancestor branch."""
        if self._slot < 0:
            return True      # the branch-head sentinel IS a tombstone
        m = self._mirror()
        return bool(m.tomb[self._slot]) or m.is_dead(self._slot)

    @property
    def value(self) -> Any:
        """Value unless deleted or root."""
        m = self._mirror()
        if self.is_root or self.is_deleted:
            return None
        return m.values[int(m.value_ref[self._slot])]

    def children(self) -> List["TableNode"]:
        """Visible children in document order."""
        return [TableNode(self._tree, s) for s in self._child_slots()]

    def _child_slots(self):
        m = self._mirror()
        if not self.is_root and self.is_deleted:
            return iter(())
        return m.iter_visible_children(self._slot)

    # -- traversal combinators over THIS node's children ------------------

    def foldl(self, func: Callable[["TableNode", Any], Any],
              acc: Any) -> Any:
        for s in self._child_slots():
            acc = func(TableNode(self._tree, s), acc)
        return acc

    def foldr(self, func: Callable[["TableNode", Any], Any],
              acc: Any) -> Any:
        for s in reversed(list(self._child_slots())):
            acc = func(TableNode(self._tree, s), acc)
        return acc

    def map(self, func: Callable[["TableNode"], Any]) -> List[Any]:
        return [func(TableNode(self._tree, s)) for s in self._child_slots()]

    def filter_map(self, func: Callable[["TableNode"], Any]) -> List[Any]:
        out = []
        for s in self._child_slots():
            v = func(TableNode(self._tree, s))
            if v is not None:
                out.append(v)
        return out

    def loop(self, func: Callable[["TableNode", Any], Tuple[str, Any]],
             acc: Any) -> Any:
        """Left fold with early exit: ``func`` returns ("take", acc) to
        continue or ("done", acc) to stop."""
        for s in self._child_slots():
            step, acc = func(TableNode(self._tree, s), acc)
            if step == "done":
                return acc
        return acc

    def find(self, pred: Callable[["TableNode"], bool]
             ) -> Optional["TableNode"]:
        """First CHAIN member matching ``pred`` — tombstones are
        candidates too, as in the reference's raw ``find``."""
        m = self._mirror()
        if not self.is_root and self.is_deleted:
            return None
        for s in m.iter_siblings(self._slot):
            n = TableNode(self._tree, s)
            if pred(n):
                return n
        return None

    def head(self) -> Optional["TableNode"]:
        for s in self._child_slots():
            return TableNode(self._tree, s)
        return None

    def last(self) -> Optional["TableNode"]:
        out = None
        for s in self._child_slots():
            out = s
        return TableNode(self._tree, out) if out is not None else None

    def descendant(self, path: Sequence[int]) -> Optional["TableNode"]:
        """Node at ``path`` relative to this node, by child timestamps:
        can land ON a tombstone but not descend through one."""
        if not path:
            return None
        m = self._mirror()
        if not self.is_root and self.is_deleted:
            return None
        cur = self._slot
        for i, ts in enumerate(path):
            if i > 0 and m.tomb[cur]:
                return None
            s = m.ts2slot.get(int(ts))
            if s is None or m.parent[s] != cur:
                return None
            cur = s
        return TableNode(self._tree, int(cur))

    def __eq__(self, other) -> bool:
        return isinstance(other, TableNode) and other._slot == self._slot \
            and other._tree is self._tree and other._gen == self._gen

    def __hash__(self) -> int:
        return hash((id(self._tree), self._slot, self._gen))

    def __repr__(self) -> str:
        if self.is_root:
            return "TableNode(root)"
        try:
            return (f"TableNode(ts={self.timestamp}, path={self.path}, "
                    f"value={self.value!r})")
        except StaleNodeView:
            return f"TableNode(stale, slot={self._slot})"


class TpuTree:
    """Array-backed replica whose bulk merges run on ``device`` (see the
    module docstring).  ``device=None`` is the card; with no card it
    raises, and ``device="cpu"`` runs the kernels' plain twins."""

    def __init__(self, replica: int, max_depth: int = DEFAULT_MAX_DEPTH,
                 device=None):
        self.device = merge_mod.resolve_device(device)
        self._replica = replica
        self._timestamp = ts_mod.make(replica, 0)
        self._cursor: Tuple[int, ...] = (0,)
        self._log = OpLog()
        self._replicas: dict = {}
        self._last_operation: Operation = Batch(())
        self._max_depth = max_depth
        self._table: Optional[NodeTable] = None
        self._packed: Optional[PackedOps] = None
        self._mirror: Optional[HostTree] = None
        self._batch_depth = 0
        # bumped whenever mirror slots are reassigned (bulk merges)
        self._generation = 0
        # per-leaf applied mask of the last successful apply
        self._last_applied_mask: Optional[np.ndarray] = None
        # op-log tiering: spills run only at commit boundaries; a
        # multi-chunk apply defers them so a failing chunk's rollback
        # target range is always still hot
        self._defer_spill = False
        # persisted materialization: True when a restore found a matz
        # artifact in the manifest — the first mirror build loads it and
        # replays only the tail instead of merging the whole history
        self._matz_pending = False
        self.matz_stats: dict = {"writes": 0, "loads": 0,
                                 "fallbacks": 0, "tail_replayed": 0}

    # -- identity / clocks -------------------------------------------------

    @property
    def replica_id(self) -> int:
        return self._replica

    @property
    def id(self) -> int:
        return self._replica

    @property
    def timestamp(self) -> int:
        return self._timestamp

    @property
    def cursor(self) -> Tuple[int, ...]:
        return self._cursor

    @property
    def last_operation(self) -> Operation:
        return self._last_operation

    @property
    def last_applied_mask(self) -> Optional[np.ndarray]:
        """Boolean per-leaf mask over the last successful
        ``apply``/``apply_packed`` batch, in submitted order: True where
        the leaf APPLIED, False where it absorbed as a duplicate."""
        return self._last_applied_mask

    @property
    def log_length(self) -> int:
        return len(self._log)

    def next_timestamp(self) -> int:
        return self._timestamp + 1

    def last_replica_timestamp(self, replica: int) -> int:
        return self._replicas.get(replica, 0)

    # -- the materialised view ---------------------------------------------

    def _materialize(self, p: PackedOps) -> NodeTable:
        """One bulk merge of a candidate packing, on this replica's
        device, in the hint mode its provenance allows.  The merge takes
        the packing's columns with their link and rank hints; under the
        exhaustive mode it derives the slot hints on the device."""
        return opsaxis.routed_materialize(p.columns(), _mode(p), self.device)

    def table(self) -> NodeTable:
        """The converged node table (host numpy), re-materialised lazily
        from the op log.  A bulk ingest parks the DEVICE table here after
        reading back only its status slice; the full host copy is paid
        on first read of the document, then cached."""
        if self._table is None:
            self._table = self._materialize(self._ensure_packed())
        if not isinstance(self._table.status, np.ndarray):
            self._table = view_mod.to_host(self._table)
        return self._table

    def _ensure_mirror(self) -> HostTree:
        """The host mirror, built lazily: from a persisted
        materialization artifact + tail replay when a tiered restore
        left one pending (O(tail since the artifact)), from the table
        when one is materialised, through the bulk merge for big logs, by
        sequential replay for small ones."""
        if self._mirror is None:
            if self._matz_pending and self._table is None:
                m = self._load_matz_mirror()
                if m is not None:
                    self._mirror = m
                    return m
            if self._table is None and len(self._log) <= DELTA_THRESHOLD:
                m = HostTree(self._max_depth)
                for op in self._log:
                    if isinstance(op, Add):
                        m.apply_add(op.ts, tuple(op.path), op.value)
                    else:
                        m.apply_delete(tuple(op.path))
                m.journal.clear()
                self._mirror = m
            else:
                self._mirror = HostTree.from_table(
                    self.table(), self._ensure_packed().values,
                    self._max_depth)
        return self._mirror

    def _stale_device(self) -> None:
        """Host-path edit: the device view no longer matches the log;
        the mirror (and outstanding views) stay valid."""
        self._table = None
        self._packed = None

    def _invalidate(self) -> None:
        """Full invalidation: slots will be reassigned — views go stale."""
        self._table = None
        self._packed = None
        self._mirror = None
        self._generation += 1

    # -- remote application ------------------------------------------------

    def apply(self, operation: Operation) -> "TpuTree":
        """Apply a remote operation/batch atomically; cursor unmoved.

        Small deltas (≤ DELTA_THRESHOLD leaves) apply sequentially on the
        host mirror, rolled back via the undo journal on failure, with
        SEQUENCE semantics; large deltas go through :meth:`_apply_bulk`
        (host-first when small relative to the document, the bulk merge
        over the whole candidate log otherwise), with SET semantics for a
        valid add set.  Duplicates and edits under deleted branches are
        absorbed; any NotFound/InvalidPath raises and leaves the replica
        untouched."""
        leaves = list(op_mod.iter_leaves(operation))
        if not leaves:
            self._last_operation = Batch(())
            self._last_applied_mask = np.zeros(0, dtype=bool)
            return self
        if len(leaves) <= DELTA_THRESHOLD:
            applied = self._apply_host(leaves)
        else:
            applied = self._apply_bulk(leaves)
        self._last_operation = (
            applied[0] if len(leaves) == 1 and applied
            else Batch(tuple(applied)))
        # the clock advances once per Add carrying our own replica id —
        # absorbed duplicates and remote-delivered ones included
        own_adds = sum(1 for op in leaves
                       if isinstance(op, Add)
                       and ts_mod.replica_id(op.ts) == self._replica)
        self._timestamp += own_adds
        self._after_commit()
        return self

    # -- op-log tiering (oplog.py) -------------------------------------------

    def enable_log_tiering(self, dir: str, *, hot_ops: int = 32768,
                           hot_bytes: int = 0, gc_min_segs: int = 4,
                           auto_stable: bool = True,
                           cache_segments: int = 2,
                           ephemeral: bool = False,
                           durable: bool = False,
                           cache_mb: Optional[int] = None,
                           base_chunk_ops: Optional[int] = None,
                           cache=None) -> "TpuTree":
        """Arm the op log's three-tier cascade (oplog module
        docstring): hot ops past the budget spill to packed-npz
        segments under ``dir`` at commit boundaries, a stability-
        watermark-gated GC folds them into a checkpoint base, and the
        full-packing cache drops whenever columns leave memory (it
        would otherwise keep the whole history resident)."""
        self._log.enable_tiering(
            dir, hot_ops=hot_ops, hot_bytes=hot_bytes,
            gc_min_segs=gc_min_segs, auto_stable=auto_stable,
            cache_segments=cache_segments, ephemeral=ephemeral,
            max_depth=self._max_depth, on_spill=self._on_log_spill,
            durable=durable, cache_mb=cache_mb,
            base_chunk_ops=base_chunk_ops, cache=cache)
        return self

    def begin_commit(self) -> tuple:
        """Snapshot the pre-commit state one commit's rollback needs: a
        merge whose WAL record cannot be made durable (ENOSPC/EIO) must
        leave the replica untouched, or the log would hold ops that
        exist in neither the tiers nor the WAL."""
        return (len(self._log), self._timestamp, dict(self._replicas),
                self._last_operation)

    @profiling.span("engine.rollback_commit")
    def rollback_commit(self, saved: tuple) -> None:
        """Undo everything since :meth:`begin_commit`: truncate the log,
        restore clocks and provenance, invalidate the view."""
        n0, timestamp, replicas, last_op = saved
        self._log.truncate(n0)
        self._timestamp = timestamp
        self._replicas = replicas
        self._last_operation = last_op
        self._invalidate()

    def manifest_meta(self) -> dict:
        """The clock/cursor meta a durable tier manifest carries —
        exactly what :meth:`checkpoint_tiered` persists, minus the
        last-operation span (a LIVE manifest is written mid-flight at
        spill boundaries; WAL replay rebuilds ``last_operation`` from
        the final record)."""
        return {
            "replica": self._replica,
            "timestamp": self._timestamp,
            "cursor": list(self._cursor),
            "replicas": {str(k): v for k, v in self._replicas.items()},
            "max_depth": self._max_depth,
        }

    def _on_log_spill(self) -> None:
        # resident columns moved to disk: holding the monolithic
        # packing would pin them all in memory anyway
        self._packed = None

    def log_view(self):
        """A reference-stable :class:`~crdt_graph_tpu_torch.oplog.LogView`
        of the applied log."""
        return self._log.view(self._max_depth)

    def _after_commit(self) -> None:
        """Commit-boundary hook: run the cascade's spill/GC unless a
        batch or chunked apply is mid-flight (their rollback paths
        truncate back into what must still be the hot tier)."""
        if self._batch_depth == 0 and not self._defer_spill:
            self._log.maybe_spill()

    def _apply_host(self, leaves: List[Operation]) -> List[Operation]:
        """Sequential host-path apply; the first failure rolls everything
        back and raises (the oracle stops there too)."""
        m = self._ensure_mirror()
        sp = m.savepoint()
        applied: List[Operation] = []
        mask = np.zeros(len(leaves), dtype=bool)
        for i, op in enumerate(leaves):
            if isinstance(op, Add):
                st = m.apply_add(op.ts, tuple(op.path), op.value)
            else:
                st = m.apply_delete(tuple(op.path))
            if st == NOT_FOUND:
                m.rollback(sp)
                raise OperationFailedError(op)
            if st == INVALID_PATH:
                m.rollback(sp)
                raise InvalidPathError(f"invalid path in {op!r}")
            if st == APPLIED:
                applied.append(op)
                mask[i] = True
        self._record(applied)
        self._last_applied_mask = mask
        if applied:
            self._stale_device()
        if self._batch_depth == 0:
            m.journal.clear()
        return applied

    def _apply_bulk(self, leaves: List[Operation]) -> List[Operation]:
        """Bulk (> DELTA_THRESHOLD) apply: a delta that is small against
        the document tries the O(delta) host mirror first (what causally
        ordered anti-entropy delivers); only when sequential application
        fails, or the delta rivals the document, does it take the bulk
        merge's set-join over log+delta."""
        if len(leaves) < max(4 * DELTA_THRESHOLD, len(self._log) // 8):
            try:
                return self._apply_host(leaves)
            except (OperationFailedError, InvalidPathError):
                pass    # rolled back; retry as an unordered set
        return self._apply_kernel(leaves)

    def apply_wire(self, payload) -> "TpuTree":
        """Remote apply straight from wire JSON (str or bytes): the
        native parser builds the columns in one pass and
        :meth:`apply_packed` routes them (a bulk merge on the card past
        the crossover, the host mirror below it).  Without the native
        module, the reference's no-native path: decode to op objects,
        then :meth:`apply`.  Raises exactly what :meth:`apply` raises."""
        from . import native
        if not native.available():
            text = payload.decode() if isinstance(payload, bytes) \
                else payload
            return self.apply(json_codec.loads(text))
        return self.apply_packed(
            native.parse_pack(payload, max_depth=self._max_depth))

    def apply_packed(self, pnew: PackedOps) -> "TpuTree":
        """Remote apply from already-packed columns."""
        # below the bulk crossover, keep apply()'s sequence-semantics
        # routing (host path / host-first)
        if not self.packed_route(pnew.num_ops):
            return self.apply(op_mod.from_list(packed_mod.unpack(pnew)))
        with profiling.span("engine.apply_packed"):
            p = self.prepare_packed(pnew)
            return self.finish_packed(pnew, p, self._materialize(p))

    def packed_route(self, n: int) -> bool:
        """True when a packed delta of ``n`` leaves takes the bulk merge;
        False routes through :meth:`apply`'s object path."""
        return n >= max(4 * DELTA_THRESHOLD, len(self._log) // 8)

    @profiling.span("engine.prepare_packed")
    def prepare_packed(self, pnew: PackedOps,
                       out: Optional[dict] = None) -> PackedOps:
        """Stage 1 of the staged bulk apply: the candidate column set
        (current log ∪ delta) whose merge yields the new view, built in
        the frame row ``out`` when given (``codec.packed.concat_many``)."""
        return packed_mod.concat_many([self._ensure_packed(), pnew], out=out)

    @profiling.span("engine.finish_packed")
    def finish_packed(self, pnew: PackedOps, p: PackedOps,
                      table: NodeTable) -> "TpuTree":
        """Stage 2 of the staged bulk apply: per-op status check, clock
        bookkeeping, columnar log commit, and view parking.  Only the
        delta's status slice is read back from the device table.  Raises
        exactly what :meth:`apply` raises, leaving the replica
        untouched."""
        n = pnew.num_ops
        n0 = len(self._log)
        with profiling.span("engine.status_readback"):
            st = table.status[n0:n0 + n]
            st = st.cpu().numpy() if not isinstance(st, np.ndarray) else st
        with profiling.span("engine.commit"):
            failing = np.nonzero((st == NOT_FOUND) |
                                 (st == INVALID_PATH))[0]
            if failing.size:
                k = int(failing[0])
                bad = packed_mod.unpack_rows(pnew, k, k + 1)[0]
                if st[k] == NOT_FOUND:
                    raise OperationFailedError(bad)
                raise InvalidPathError(f"invalid path in {bad!r}")

            # vectorized clocks: LAST-APPLIED-WINS per replica, and a
            # Delete updates the TARGET timestamp's replica (the packed ts
            # column holds exactly that per kind)
            kind = pnew.kind[:n]
            ts_col = pnew.ts[:n]
            idx = np.nonzero(st == APPLIED)[0]
            ts_eff = ts_col[idx]
            rids = ts_eff >> 32
            uniq, inv = np.unique(rids, return_inverse=True)
            last = np.zeros(uniq.size, np.int64)
            np.maximum.at(last, inv, np.arange(idx.size))
            for k in range(uniq.size):
                self._replicas[int(uniq[k])] = int(ts_eff[last[k]])

            if idx.size == n:
                self._log.extend_packed(pnew)
                self._last_operation = PackedBatch(pnew)
                self._commit_view(True, p, table)
            elif idx.size:
                sel = packed_mod.select_rows(pnew, idx)
                self._log.extend_packed(sel)
                self._last_operation = PackedBatch(sel)
                self._commit_view(False, p, table)
            else:
                self._last_operation = Batch(())
            # own-op clock: every own-replica Add in the BATCH advances it
            self._timestamp += int(np.sum(
                (kind == packed_mod.KIND_ADD) &
                ((ts_col >> 32) == self._replica)))
            self._last_applied_mask = np.asarray(st == APPLIED)
            self._after_commit()
        return self

    def apply_packed_chunked(self, pnew: PackedOps,
                             chunk_ops: int) -> "TpuTree":
        """:meth:`apply_packed` with the work split into row chunks of at
        most ``chunk_ops`` leaves.  Atomic: a failing chunk rolls the
        log, clocks and view back to the pre-call state, then the whole
        batch is retried single-shot.  On success the converged state
        equals the single-shot apply."""
        n = pnew.num_ops
        if n <= chunk_ops or not self.packed_route(n):
            return self.apply_packed(pnew)
        n0 = len(self._log)
        saved = (self._timestamp, dict(self._replicas),
                 self._last_operation)
        masks: List[np.ndarray] = []
        # spills defer until the LAST chunk commits: a failing chunk
        # truncates back to n0, which must still be in the hot tier
        defer0 = self._defer_spill
        self._defer_spill = True
        try:
            for s in range(0, n, chunk_ops):
                chunk = packed_mod.select_rows(
                    pnew, np.arange(s, min(s + chunk_ops, n)))
                self.apply_packed(chunk)
                masks.append(self._last_applied_mask)
        except (OperationFailedError, InvalidPathError):
            self._log.truncate(n0)
            (self._timestamp, self._replicas,
             self._last_operation) = saved
            self._invalidate()
            self._defer_spill = defer0
            return self.apply_packed(pnew)
        finally:
            self._defer_spill = defer0
        mask = np.concatenate(masks) if masks else np.zeros(0, bool)
        applied = int(mask.sum())
        if applied == n:
            self._last_operation = PackedBatch(pnew)
        elif applied:
            self._last_operation = PackedBatch(
                packed_mod.select_rows(pnew, np.nonzero(mask)[0]))
        else:
            self._last_operation = Batch(())
        self._last_applied_mask = mask
        self._after_commit()
        return self

    def _apply_kernel(self, leaves: List[Operation]) -> List[Operation]:
        p = packed_mod.concat(self._ensure_packed(),
                              packed_mod.pack(leaves,
                                              max_depth=self._max_depth))
        table = self._materialize(p)
        n0 = len(self._log)
        st = table.status[n0:n0 + len(leaves)].cpu().numpy()
        failing = np.nonzero((st == NOT_FOUND) | (st == INVALID_PATH))[0]
        if failing.size:
            # the FIRST failing op in batch order, by its own error
            k = int(failing[0])
            if st[k] == NOT_FOUND:
                raise OperationFailedError(leaves[k])
            raise InvalidPathError(f"invalid path in {leaves[k]!r}")
        applied = [op for op, s in zip(leaves, st) if s == APPLIED]
        self._commit(applied, len(leaves) == len(applied), p, table)
        self._last_applied_mask = np.asarray(st == APPLIED)
        return applied

    def _record(self, applied: List[Operation]) -> None:
        for op in applied:
            ts = op_mod.op_timestamp(op)
            if ts is not None:
                self._replicas[ts_mod.replica_id(ts)] = ts
        self._log.extend(applied)

    def _commit(self, applied: List[Operation], all_applied: bool,
                p: PackedOps, table: NodeTable) -> None:
        self._record(applied)
        if applied:
            self._commit_view(all_applied, p, table)

    def _commit_view(self, all_applied: bool, p: PackedOps,
                     table: NodeTable) -> None:
        """A fully-applied batch's candidate packing == the new log
        packing, so the view is reused (mirror slots are reassigned —
        outstanding views go stale); a partial apply re-materialises
        from the log on next read."""
        if all_applied:
            self._table, self._packed = table, p
            self._mirror = None
            self._generation += 1
        else:
            self._invalidate()

    # -- local edits -------------------------------------------------------

    def add(self, value: Any) -> "TpuTree":
        return self.add_after(self._cursor, value)

    def add_after(self, path: Sequence[int], value: Any) -> "TpuTree":
        op = Add(self.next_timestamp(), tuple(path), value)
        self._apply_local(op)
        return self

    def add_branch(self, value: Any) -> "TpuTree":
        self.add(value)
        self._cursor = self._cursor + (0,)
        return self

    def delete(self, path: Sequence[int]) -> "TpuTree":
        path = tuple(path)
        prev_path = self._predecessor_path(path)
        self._apply_local(Delete(path))
        if self._slot_at(prev_path) is not None or prev_path == path:
            self._cursor = prev_path
        return self

    def batch(self, funcs: Iterable[Callable[["TpuTree"], "TpuTree"]]
              ) -> "TpuTree":
        """Atomic local batch; accumulated last_operation like the
        oracle."""
        log_len0 = len(self._log)
        saved = (self._timestamp, self._cursor,
                 dict(self._replicas), self._last_operation)
        m0 = self._ensure_mirror()
        sp = m0.savepoint()
        self._last_operation = Batch(())
        acc: List[Operation] = []
        self._batch_depth += 1
        try:
            for f in funcs:
                f(self)
                acc.extend(op_mod.to_list(self._last_operation))
        except Exception:
            self._log.truncate(log_len0)
            (self._timestamp, self._cursor,
             self._replicas, self._last_operation) = saved
            if self._mirror is m0 and len(m0.journal) >= sp:
                # every edit since the savepoint was host-path
                m0.rollback(sp)
                self._stale_device()
            else:
                # a bulk merge replaced the mirror mid-batch
                self._invalidate()
            raise
        finally:
            self._batch_depth -= 1
        if self._batch_depth == 0 and self._mirror is not None:
            self._mirror.journal.clear()
        self._last_operation = Batch(tuple(acc))
        self._after_commit()
        return self

    def _apply_local(self, op: Operation) -> None:
        saved_cursor = self._cursor
        self.apply(op)
        ts = op_mod.op_timestamp(op)
        # cursor follows local edits; absorbed ops leave it in place
        if ts is not None and isinstance(op, (Add, Delete)):
            if op_mod.to_list(self._last_operation):
                self._cursor = tuple(op.path[:-1]) + (ts,)
            else:
                self._cursor = saved_cursor

    def _predecessor_path(self, path: Tuple[int, ...]) -> Tuple[int, ...]:
        """Predecessor for post-delete cursor placement, matching the
        reference's search: the nearest visible predecessor, or the first
        tombstone of a leading tombstone run, or the target's own path
        when it heads the chain."""
        m = self._ensure_mirror()
        if path and path[-1] == 0:
            # the branch-head sentinel: the delete absorbs, cursor stays
            return path
        idx = m.get_slot(tuple(path))
        if idx is not None and m.tomb[idx]:
            return path
        if idx is None:
            # missing or dead target: the root branch's last chain member
            # with no visible successor
            chain = list(m.iter_siblings(0))
            vis = [s for s in chain if not m.tomb[s]]
            if vis:
                return m.path_of(vis[-1])
            return m.path_of(chain[0]) if chain else path
        p = m.prev_for(idx)
        return m.path_of(p) if p is not None else path

    # -- anti-entropy ------------------------------------------------------

    def operations_since(self, initial_timestamp: int) -> Operation:
        """Anti-entropy suffix (inclusive ``since`` terminator)."""
        if initial_timestamp == 0:
            return self._log.as_batch()
        start = self._log.index_of_add(initial_timestamp)
        if start is None:
            return Batch(())
        return op_mod.from_list(
            self._log.materialize(start, len(self._log)))

    def dumps_since_bytes(self, initial_timestamp: int) -> bytes:
        """Wire JSON bytes for ``operations_since`` without per-op
        Python encode — ``codec.packed.packed_since_bytes`` over the cached
        packed log, byte-identical to
        ``json_codec.dumps(self.operations_since(ts))``.  Without the
        native module, the reference's no-native path: encoded from the
        object log."""
        from . import native
        if not native.available():
            return json_codec.dumps(
                self.operations_since(initial_timestamp)).encode()
        return packed_mod.packed_since_bytes(self._ensure_packed(),
                                             initial_timestamp)

    def dumps_since(self, initial_timestamp: int) -> str:
        return self.dumps_since_bytes(initial_timestamp).decode()

    # -- queries -----------------------------------------------------------

    def _slot_at(self, path: Tuple[int, ...]) -> Optional[int]:
        return self._ensure_mirror().get_slot(tuple(path))

    def get_value(self, path: Sequence[int]) -> Any:
        """Value at path; None if missing, deleted, or under a deleted
        branch."""
        m = self._ensure_mirror()
        s = m.get_slot(tuple(path))
        if s is None or s == 0 or m.tomb[s]:
            return None
        return m.values[int(m.value_ref[s])]

    def _ensure_packed(self) -> PackedOps:
        p = self._packed
        if p is None:
            p = self._packed = self._log.to_packed(self._max_depth)
        return p

    def packed_state(self) -> PackedOps:
        """The whole applied log as one packed column set (cached between
        edits); treat as IMMUTABLE."""
        return self._ensure_packed()

    def visible_values(self) -> List[Any]:
        """Visible values in document order — the render path.  A
        mirror freshly loaded from a materialization artifact answers
        from its persisted visible sequence (one list copy) until the
        first applied mutation invalidates it."""
        m = self._ensure_mirror()
        if m.vis_cache is not None:
            return list(m.vis_cache)
        return [m.values[int(m.value_ref[s])] for s in m.iter_visible()]

    # -- node views and traversal -------------------------------------------

    def root(self) -> TableNode:
        return TableNode(self, 0)

    def get(self, path: Sequence[int]) -> Optional[TableNode]:
        """Node at ``path`` (tombstones included) or None.  A trailing-0
        path addresses the branch-head SENTINEL, which exists under the
        root and under every live node."""
        path = tuple(path)
        if path and path[-1] == 0:
            if len(path) == 1:
                return TableNode(self, -1)
            m = self._ensure_mirror()
            s = m.get_slot(path[:-1])
            if s is not None and s != 0 and not m.tomb[s]:
                return TableNode(self, -1)
            return None
        slot = self._slot_at(path)
        return TableNode(self, slot) if slot is not None else None

    def parent(self, node: TableNode) -> Optional[TableNode]:
        node._check()
        if node.is_root:
            return None
        if node._slot < 0:
            return TableNode(self, 0)
        return TableNode(self, int(self._ensure_mirror().parent[node._slot]))

    def next(self, node: TableNode) -> Optional[TableNode]:
        """Next visible sibling; none in a deleted branch."""
        node._check()
        m = self._ensure_mirror()
        if node.is_root or node._slot < 0 or m.is_dead(node._slot):
            return None
        s = m.nxt[node._slot]
        while s != NIL and m.tomb[s]:
            s = m.nxt[s]
        return TableNode(self, int(s)) if s != NIL else None

    def prev(self, node: TableNode) -> Optional[TableNode]:
        """Previous sibling, reference-faithfully: the nearest visible
        predecessor, else the FIRST tombstone of a leading run."""
        node._check()
        m = self._ensure_mirror()
        if node.is_root or node._slot < 0 or m.is_dead(node._slot):
            return None
        p = m.prev_for(node._slot)
        return TableNode(self, p) if p is not None else None

    def walk(self, func: Callable[[TableNode, Any], Tuple[str, Any]],
             acc: Any, start: Optional[TableNode] = None) -> Any:
        """Resumable depth-first fold over visible nodes in document
        order, with early exit; ``start`` is exclusive."""
        if start is not None:
            start._check()
        m = self._ensure_mirror()
        if start is None or start.is_root:
            it = m.iter_visible()
        elif m.is_dead(start._slot):
            return acc
        else:
            it = m.iter_visible_after(start._slot)
        for s in it:
            step, acc = func(TableNode(self, s), acc)
            if step == "done":
                return acc
        return acc

    def visible_paths(self) -> List[tuple]:
        m = self._ensure_mirror()
        return [m.path_of(s) for s in m.iter_visible()]

    def move_cursor_up(self) -> "TpuTree":
        if len(self._cursor) > 1:
            self._cursor = self._cursor[:-1]
        return self

    def set_cursor(self, path: Sequence[int]) -> "TpuTree":
        path = tuple(path)
        if self.get(path) is None:
            raise NotFound(f"no node at {path!r}")
        self._cursor = path
        return self

    def __len__(self) -> int:
        return self._ensure_mirror().count_visible()

    def __repr__(self) -> str:
        return (f"TpuTree(replica={self._replica}, ops={len(self._log)}, "
                f"ts={self._timestamp}, device={self.device})")

    # -- interop / persistence ---------------------------------------------

    def to_oracle(self):
        """Replay into a full-API oracle ``CRDTree`` (persistent value)."""
        from .core.tree import CRDTree
        tree = CRDTree.init(self._replica)
        tree = tree.apply(self.operations_since(0))
        return tree._replace(timestamp=self._timestamp,
                             cursor=self._cursor)

    def checkpoint(self, path: str) -> None:
        """Persist the replica as JSON: the op log plus clocks and cursor
        (the reference's format).  Values must be JSON-encodable."""
        state = {
            "replica": self._replica,
            "timestamp": self._timestamp,
            "cursor": list(self._cursor),
            "replicas": {str(k): v for k, v in self._replicas.items()},
            "log": json_codec.encode(Batch(tuple(self._log))),
            "last_operation": json_codec.encode(self._last_operation),
            "max_depth": self._max_depth,
        }
        with open(path, "w") as f:
            json.dump(state, f)

    @staticmethod
    def restore(path: str, device=None) -> "TpuTree":
        with open(path) as f:
            state = json.load(f)
        tree = TpuTree(state["replica"], max_depth=state["max_depth"],
                       device=device)
        tree._log = OpLog(json_codec.decode(state["log"]).ops)
        tree._timestamp = state["timestamp"]
        tree._cursor = tuple(state["cursor"])
        tree._replicas = {int(k): v for k, v in state["replicas"].items()}
        tree._last_operation = json_codec.decode(state["last_operation"])
        return tree

    def checkpoint_packed(self, path, compress: bool = True) -> None:
        """Binary checkpoint: the packed op columns plus clocks, written
        with numpy in the reference's format (byte-compatible both ways).
        ``path`` may be a binary file-like object."""
        p = self._ensure_packed()
        meta = {
            "replica": self._replica,
            "timestamp": self._timestamp,
            "cursor": list(self._cursor),
            "replicas": {str(k): v for k, v in self._replicas.items()},
            "max_depth": self._max_depth,
            "num_ops": p.num_ops,
            "hints_vouched": p.hints_vouched,
        }
        self._last_op_meta(meta)
        packed_mod.write_packed_npz(path, p, meta, compress=compress)

    def _last_op_meta(self, meta: dict) -> None:
        """Stamp ``last_operation`` provenance into a checkpoint ``meta``:
        the row SPAN when the last operation is the log's tail, else the
        encoded operation."""
        lo = self._last_operation
        if isinstance(lo, ViewSpanBatch):
            meta["last_op_span"] = [lo._start, lo._stop]
            meta["last_op_bare"] = False
        elif isinstance(lo, PackedBatch) and self._log.tail_is(lo):
            meta["last_op_span"] = [len(self._log) - lo.num_leaves,
                                    len(self._log)]
            meta["last_op_bare"] = False
        else:
            leaves = op_mod.to_list(lo)
            k = len(leaves)
            tail = self._log[len(self._log) - k:] if k else []
            if len(tail) == k and (
                    all(a is b for a, b in zip(leaves, tail))
                    or leaves == tail):
                meta["last_op_span"] = [len(self._log) - k, len(self._log)]
                meta["last_op_bare"] = not isinstance(lo, Batch)
            else:
                meta["last_operation"] = json_codec.encode(lo)

    @staticmethod
    def restore_packed(path, replica: Optional[int] = None,
                       device=None) -> "TpuTree":
        """Rebuild a tree from ``checkpoint_packed`` output (this
        package's or the reference's); ``path`` may be a binary
        file-like.  ``replica`` adopts a NEW identity for the restored
        tree (the snapshot-bootstrap contract).  A corrupt or
        hand-edited file raises :class:`CheckpointError`."""
        if replica is not None:
            ts_mod.make(replica, 0)
        dev = merge_mod.resolve_device(device)
        try:
            p, meta, last_op = TpuTree._load_packed_parts(path)
        except (zipfile.BadZipFile, zlib.error, KeyError, IndexError,
                ValueError, TypeError, AttributeError,
                NotImplementedError, EOFError, struct.error) as e:
            raise CheckpointError(
                f"corrupt or unreadable checkpoint: "
                f"{type(e).__name__}: {e}") from e
        return TpuTree._assemble_restored(p, meta, last_op, replica, dev)

    @staticmethod
    def _load_packed_parts(path):
        """Load + parse + validate a packed checkpoint: everything whose
        failure means "corrupt/truncated/hand-edited file".  Returns
        ``(p, meta, last_op)`` with every meta field assembly touches
        already type-checked."""
        z = np.load(path)
        meta = json.loads(bytes(z["meta"]).decode())
        n = meta.get("num_ops")
        if not isinstance(n, int) or isinstance(n, bool) or \
                not (0 <= n <= int(z["kind"].shape[0])):
            raise ValueError(
                f"meta num_ops {n!r} inconsistent with "
                f"column length {int(z['kind'].shape[0])}")

        def _int(name, value):
            if not isinstance(value, int) or isinstance(value, bool):
                raise ValueError(f"meta {name} {value!r} is not an integer")
            return value

        ts_mod.make(_int("replica", meta["replica"]), 0)
        _int("timestamp", meta["timestamp"])
        if _int("max_depth", meta["max_depth"]) < 1:
            raise ValueError(f"meta max_depth {meta['max_depth']!r} < 1")
        if not isinstance(meta["cursor"], list):
            raise ValueError(f"meta cursor {meta['cursor']!r} not a list")
        meta["cursor"] = [_int("cursor entry", c) for c in meta["cursor"]]
        if not isinstance(meta["replicas"], dict):
            raise ValueError("meta replicas is not a mapping")
        meta["replicas"] = {int(k): _int("clock", v)
                            for k, v in meta["replicas"].items()}
        last_op = None
        if "last_op_span" in meta:
            span = meta["last_op_span"]
            if not (isinstance(span, list) and len(span) == 2):
                raise ValueError(f"meta last_op_span {span!r} malformed")
            s, e = (_int("last_op_span", x) for x in span)
            if not (0 <= s <= e <= n):
                raise ValueError(f"meta last_op_span {span!r} outside "
                                 f"the {n}-op log")
        else:
            last_op = json_codec.decode(meta["last_operation"])

        # files hold exactly num_ops rows; re-pad to the capacity bucket
        cols = {k: z[k] for k in
                ("kind", "ts", "parent_ts", "anchor_ts", "depth",
                 "paths", "value_ref", "pos")}
        for k in ("parent_pos", "anchor_pos", "target_pos", "ts_rank"):
            if k in z.files:
                cols[k] = z[k]
        cols = packed_mod.pad_arrays(cols, packed_mod._bucket(max(n, 1)))
        p = PackedOps(
            kind=cols["kind"], ts=cols["ts"],
            parent_ts=cols["parent_ts"],
            anchor_ts=cols["anchor_ts"], depth=cols["depth"],
            paths=cols["paths"],
            value_ref=cols["value_ref"], pos=cols["pos"],
            values=json.loads(bytes(z["values"]).decode()),
            num_ops=n,
            # older checkpoints lack hint columns: defaulted -1, and the
            # merge's verified auto mode takes the sort+join
            parent_pos=cols.get("parent_pos"),
            anchor_pos=cols.get("anchor_pos"),
            target_pos=cols.get("target_pos"),
            ts_rank=cols.get("ts_rank"),
            hints_vouched=bool(meta.get("hints_vouched", False)))
        # the vouch rides in the same file as the columns it vouches
        # for: re-verify on host before honoring it, and rebuild the
        # hints rather than demote on failure
        if p.hints_vouched and not packed_mod.verify_hints(p):
            packed_mod.rebuild_hints(p)
        if last_op is None and meta.get("last_op_bare"):
            s, e = meta["last_op_span"]
            if e - s == 1:
                last_op = packed_mod.unpack_rows(p, s, e)[0]
        return p, meta, last_op

    @staticmethod
    def _assemble_restored(p, meta, last_op, replica, device) -> "TpuTree":
        """Build the tree from validated parts — outside the
        corrupt-checkpoint translation."""
        rid = meta["replica"] if replica is None else replica
        tree = TpuTree(rid, max_depth=meta["max_depth"], device=device)
        tree._log = OpLog()
        tree._log.extend_packed(p)
        tree._packed = p
        tree._cursor = tuple(meta["cursor"])
        tree._replicas = dict(meta["replicas"])
        if rid == meta["replica"]:
            tree._timestamp = meta["timestamp"]
        else:
            # a new identity restarts its clock at its own last timestamp
            # seen in the log, never at the writer's
            tree._timestamp = max(ts_mod.make(rid, 0),
                                  tree._replicas.get(rid, 0))
        if last_op is not None:
            tree._last_operation = last_op
        else:
            s, e = meta["last_op_span"]
            tree._last_operation = PackedBatch(p, s, e)
        return tree

    # -- persisted materialization ("matz") ----------------------------------

    def _matz_mirror_cheap(self) -> Optional[HostTree]:
        """The mirror IF it is derivable without a full-history merge:
        already built, rebuildable from a parked table, loadable from
        a pending artifact, or a small log.  None otherwise — a matz
        write must never INTRODUCE the cold-path cost it exists to
        remove."""
        if self._mirror is not None or self._table is not None \
                or self._matz_pending \
                or len(self._log) <= DELTA_THRESHOLD:
            return self._ensure_mirror()
        return None

    def _save_matz_npz(self, target: str, name: str, arrs: dict,
                       values: list, meta: dict, fsync: bool) -> None:
        """Serialize one materialization artifact (tmp + rename so a
        manifest-referenced artifact is never observed
        half-written)."""
        os.makedirs(target, exist_ok=True)
        path = os.path.join(target, name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, values=np.frombuffer(
                json.dumps(values).encode(), np.uint8),
                meta=np.frombuffer(json.dumps(meta).encode(),
                                   np.uint8),
                **arrs)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        self.matz_stats["writes"] += 1

    def _write_matz_file(self, target: str,
                         fsync: bool = False) -> Optional[dict]:
        """Write the materialization artifact (mirror slot arrays +
        values + visible sequence) into ``target`` and return its
        manifest entry ``{"file", "len"}``, or None when no mirror is
        cheaply derivable."""
        m = self._matz_mirror_cheap()
        if m is None:
            return None
        length = len(self._log)
        name = self._log.next_matz_name() \
            if self._log.tiering_enabled else "matz-g1.npz"
        meta = {"kind": "matz", "matz_len": length, "n": m.n,
                "nvis": m.nvis, "max_depth": self._max_depth,
                "values_len": len(m.values)}
        self._save_matz_npz(target, name, m.export_arrays(),
                            m.values, meta, fsync)
        return {"file": name, "len": length}

    def matz_snapshot(self) -> Optional[dict]:
        """The scheduler-thread half of the BACKGROUND materialization
        export: spill the whole hot tail first (the
        artifact's coverage must stay ≤ the tiered extent — the usual
        write_matz rule), then snapshot the mirror's slot arrays
        COPY-ON-EXPORT, so the maintenance worker can serialize the
        O(doc-state) artifact while this thread keeps applying ops to
        the live mirror.  The copies are flat memcpys + one pointer
        copy of the value table (values are immutable JSON leaves) —
        milliseconds where the serialize is seconds.  None when no
        mirror is cheaply derivable (never introduces the cost it
        removes)."""
        log = self._log
        if not matz_enabled() or not log.tiering_enabled:
            return None
        m = self._matz_mirror_cheap()
        if m is None:
            return None
        log.spill_all()
        arrs = m.export_arrays(copy=True)
        return {"arrs": arrs, "values": list(m.values), "n": m.n,
                "nvis": m.nvis, "len": len(log),
                "values_len": len(m.values)}

    def export_matz(self, snap: dict) -> bool:
        """The worker-thread half: serialize a :meth:`matz_snapshot`
        to its artifact file and publish it atomically in the
        manifest.  If the log was truncated below the snapshot's
        coverage in the meantime (a shed rollback), the artifact is
        DISCARDED — it must never resurrect rolled-back ops."""
        from .wal import maybe_crash
        log = self._log
        cfg = log._cfg
        if cfg is None or snap is None:
            return False
        name = log.next_matz_name()
        meta = {"kind": "matz", "matz_len": int(snap["len"]),
                "n": snap["n"], "nvis": snap["nvis"],
                "max_depth": self._max_depth,
                "values_len": snap["values_len"]}
        self._save_matz_npz(cfg.dir, name, snap["arrs"],
                            snap["values"], meta, fsync=cfg.durable)
        # chaos site: artifact on disk, manifest not yet referencing
        # it — recovery from the old manifest ignores the stray file
        maybe_crash("mid-matz-write")
        try:
            log.note_matz(name, int(snap["len"]))
        except ValueError:
            try:
                os.remove(os.path.join(cfg.dir, name))
            except OSError:
                pass
            return False
        return True

    def write_matz(self) -> bool:
        """Serving-path materialization snapshot: spill the whole hot
        tail (so the artifact's coverage is ≤ the tiered extent — a
        restore always finds every covered op in the tiers, never in
        an unsynced WAL tail that might not have survived), write the
        artifact, and publish it atomically in the manifest.  Returns
        True when an artifact landed.  Requires tiering; no-op when
        the mirror is not cheaply derivable or ``GRAFT_MATZ=0``."""
        from .wal import maybe_crash
        log = self._log
        if not matz_enabled() or not log.tiering_enabled:
            return False
        if self._matz_mirror_cheap() is None:
            return False
        log.spill_all()
        cfg = log._cfg
        entry = self._write_matz_file(cfg.dir, fsync=cfg.durable)
        if entry is None:
            return False
        # chaos site: artifact on disk, manifest not yet referencing
        # it — recovery from the old manifest ignores the stray file
        maybe_crash("mid-matz-write")
        log.note_matz(entry["file"], entry["len"])
        return True

    def _load_matz_mirror(self) -> Optional[HostTree]:
        """Rebuild the mirror from the manifest's materialization
        artifact + an O(tail) replay of the ops past its coverage.
        Any inconsistency — corrupt/truncated/missing artifact, a
        coverage beyond the restored log, a tail op the artifact
        state rejects — falls back to the full first-merge path with
        a typed :class:`MatzWarning` and a counted fallback: stale is
        absorbed, wrong is impossible, slow is the worst case."""
        import warnings
        self._matz_pending = False          # consume once
        log = self._log
        cfg = log._cfg
        entry = log.matz_entry
        if entry is None or cfg is None or not matz_enabled():
            return None
        length = int(entry["len"])
        try:
            if length > len(log):
                raise CheckpointError(
                    f"matz artifact covers {length} ops; restored "
                    f"log holds {len(log)}")
            z = np.load(os.path.join(cfg.dir, entry["file"]))
            meta = json.loads(bytes(z["meta"]).decode())
            if meta.get("kind") != "matz" \
                    or int(meta["matz_len"]) != length:
                raise ValueError(f"matz meta mismatch: {meta!r}")
            nvis = int(meta["nvis"])
            values = json.loads(bytes(z["values"]).decode())
            if not isinstance(values, list) \
                    or len(values) != int(meta["values_len"]):
                raise ValueError("matz value table inconsistent")
            arrs = {k: z[k] for k in
                    ("ts", "parent", "depth", "value_ref", "tomb",
                     "first", "nxt", "prv")}
            m = HostTree.from_arrays(arrs, values, self._max_depth,
                                     nvis)
            vis_refs = np.asarray(z["vis_refs"])
            if vis_refs.shape != (nvis,) or (nvis and (
                    int(vis_refs.min()) < 0
                    or int(vis_refs.max()) >= len(values))):
                raise ValueError("matz visible sequence inconsistent")
            vals_arr = np.empty(len(values), dtype=object)
            vals_arr[:] = values
            m.vis_cache = vals_arr[vis_refs].tolist()
            # tail replay: only the ops past the artifact's coverage
            # (loads only their covering chunks); duplicates absorb,
            # anything the artifact state rejects is inconsistency
            tail = log.materialize(length, len(log))
            for op in tail:
                if isinstance(op, Add):
                    st = m.apply_add(op.ts, tuple(op.path), op.value)
                else:
                    st = m.apply_delete(tuple(op.path))
                if st in (NOT_FOUND, INVALID_PATH):
                    raise CheckpointError(
                        f"matz tail replay rejected {op!r}")
            m.journal.clear()
        except (CheckpointError, OSError, zipfile.BadZipFile,
                zlib.error, KeyError, IndexError, ValueError,
                TypeError, AttributeError, EOFError,
                struct.error) as e:
            self.matz_stats["fallbacks"] += 1
            warnings.warn(
                f"materialization artifact unusable "
                f"({type(e).__name__}: {e}); falling back to the "
                f"full first-merge materialization", MatzWarning,
                stacklevel=3)
            return None
        self.matz_stats["loads"] += 1
        self.matz_stats["tail_replayed"] += len(log) - length
        return m

    def checkpoint_tiered(self, dir: str,
                          write_matz: bool = True) -> str:
        """Tiered checkpoint: the cascade's base chunks + cold
        segments stay where they are, the hot tail spills to one final
        segment, and a ``manifest.json`` (tier layout + clocks/cursor
        meta) makes the directory self-describing — so restore is
        *checkpoint + tail* (descriptor opens, O(tail) work) instead
        of a full-history replay.  An untiered tree enables the
        cascade at ``dir`` first (non-ephemeral: a checkpoint must
        survive its writer).

        ``write_matz`` (and ``GRAFT_MATZ``): also persist the
        MATERIALIZED state artifact when the mirror/table is already
        in hand, so the restored document's FIRST READ is O(tail)
        too, not one full-history merge.  Skipped silently when
        deriving it would itself cost a full merge.

        ``last_operation`` persists as a row span (the
        :meth:`checkpoint_packed` policy).  Returns the manifest path.

        ``dir`` is honored even when the cascade is already armed
        elsewhere (a served document tiers into ephemeral engine
        scratch): the segment files are then COPIED into ``dir``, so
        the checkpoint survives the engine that wrote it."""
        if not self._log.tiering_enabled:
            self.enable_log_tiering(dir, ephemeral=False)
        meta = self.manifest_meta()
        # last_operation provenance survives the round trip (the
        # _last_op_meta policy shared with checkpoint_packed)
        self._last_op_meta(meta)
        matz_entry = None
        if write_matz and matz_enabled():
            cfg = self._log._cfg
            matz_entry = self._write_matz_file(
                dir, fsync=cfg.durable if cfg is not None else False)
        path = self._log.persist(meta, dir=dir, matz=matz_entry)
        # the hot tail just spilled: drop the monolithic cache like any
        # other spill (persist bypasses the maybe_spill hook)
        self._packed = None
        return path

    @staticmethod
    def restore_tiered(dir: str, replica: Optional[int] = None,
                       use_matz: bool = True, device=None,
                       **tier_kw) -> "TpuTree":
        """Rebuild a tree from :meth:`checkpoint_tiered` output —
        O(tail) descriptor opens, no replay, no full column load (cold
        tiers page in lazily on first read).  When the manifest
        references a materialization artifact (and ``use_matz`` /
        ``GRAFT_MATZ`` allow), the FIRST READ also stays O(tail): the
        mirror loads from the artifact and replays only the ops past
        its coverage; a corrupt/stale/missing artifact falls back to
        the full merge with a :class:`MatzWarning` — never wrong
        data.  ``replica`` adopts a new identity exactly like
        :meth:`restore_packed`; ``device`` is where the replica's bulk
        merges run (the card unless named; nothing is put there at
        restore).  Raises
        :class:`~crdt_graph_tpu_torch.core.errors.CheckpointError`
        (typed, never a silent partial log) on any missing or corrupt
        manifest or segment file."""
        dev = merge_mod.resolve_device(device)
        if replica is not None:
            ts_mod.make(replica, 0)
        log, meta = OpLog.open_dir(dir, **tier_kw)
        try:
            rid_meta = meta["replica"]
            ts_mod.make(int(rid_meta), 0)
            max_depth = int(meta["max_depth"])
            if max_depth < 1:
                raise ValueError(f"max_depth {max_depth}")
            cursor = tuple(int(c) for c in meta["cursor"])
            replicas = {int(k): int(v)
                        for k, v in meta["replicas"].items()}
            timestamp = int(meta["timestamp"])
            last_op: Optional[Operation] = None
            span = meta.get("last_op_span")
            if span is not None:
                if not (isinstance(span, list) and len(span) == 2
                        and all(isinstance(x, int)
                                and not isinstance(x, bool)
                                for x in span)
                        and 0 <= span[0] <= span[1] <= len(log)):
                    raise ValueError(f"last_op_span {span!r} outside "
                                     f"the {len(log)}-op log")
            elif "last_operation" in meta:
                last_op = json_codec.decode(meta["last_operation"])
        except (KeyError, ValueError, TypeError, AttributeError) as e:
            raise CheckpointError(
                f"tiered checkpoint meta in {dir!r} invalid: "
                f"{type(e).__name__}: {e}") from e
        rid = rid_meta if replica is None else replica
        tree = TpuTree(rid, max_depth=max_depth, device=dev)
        log._cfg.max_depth = max_depth
        tree._log = log
        log.set_on_spill(tree._on_log_spill)
        if use_matz and log.matz_entry is not None:
            tree._matz_pending = True
        tree._cursor = cursor
        tree._replicas = replicas
        if rid == rid_meta:
            tree._timestamp = timestamp
        else:
            tree._timestamp = max(ts_mod.make(rid, 0),
                                  replicas.get(rid, 0))
        # last_operation round-trips: a span
        # rebuilds LAZILY off the restored view (the span may be a
        # whole bootstrap ingest living in cold segments — restore
        # must stay O(tail)); a bare single op materializes eagerly so
        # the restored echo keeps the reference's bare-op shape; old
        # manifests without either key keep the empty-batch sentinel.
        if span is not None:
            s, e = span
            if e > s:
                vb = ViewSpanBatch(log.view(max_depth), s, e)
                if meta.get("last_op_bare") and e - s == 1:
                    tree._last_operation = vb.ops[0]
                else:
                    tree._last_operation = vb
        elif last_op is not None:
            tree._last_operation = last_op
        return tree


def _finish_each(i: int, commit: Callable[[], None]) -> None:
    """:func:`apply_packed_grouped`'s default stand around a commit: a
    rejected delta is the document's own entry, never the caller's
    exception."""
    try:
        commit()
    except CRDTError:
        pass


def apply_packed_grouped(trees: Sequence[TpuTree],
                         deltas: Sequence[PackedOps],
                         times: Optional[dict] = None,
                         each: Callable[[int, Callable[[], None]],
                                        None] = _finish_each
                         ) -> List[Optional[CRDTError]]:
    """Catch several replicas up in one merge: one packed delta a tree,
    merged as ONE batched merge over a leading document axis on the
    trees' device (the serving scheduler's cross-document round).

    The round's ``[B, N]`` column frame (``[B, N, W]`` paths;
    ``codec.packed.frame``) is allocated first, ``N`` and ``W`` the
    largest capacity and path width of the B candidate sets
    (``codec.packed.union_shape``), and each tree's candidate set
    (:meth:`TpuTree.prepare_packed`) is built straight into its row:
    the frame IS the stack, with no second copy of any column.  The
    stack is merged by ``mesh.batched_materialize`` on the join leg (the
    batched body drops the position hints), and each tree commits
    against its own slice of the one table (:meth:`TpuTree.finish_packed`
    on ``mesh.doc_table``), in order.  A document's slice is the merge
    of its own op set alone.  The candidate set a tree parks is a view
    of its row, so the round's frame lives while any document's parked
    state refers to it; a round never reuses an earlier frame.

    Returns one entry per tree: None when it committed, or the
    :class:`CRDTError` its commit raised, which leaves that tree
    untouched while the others still commit.  Raises ``ValueError``
    before anything runs when the deltas do not pair with the trees, the
    trees lie on more than one device, or a delta would not take the
    bulk route (:meth:`TpuTree.packed_route`); a failing prepare or merge
    raises before any tree commits.

    ``times``, when given, receives ``prepare_ms`` (the prepares and the
    stack) and ``launch_ms`` (the batched merge) before the first
    commit.  ``each(i, commit)`` stands around tree ``i``'s commit, for
    every tree in order, and runs ``commit()``, which raises what the
    commit raised; the serving scheduler keeps its per-document
    bookkeeping there.

    The span tree of one call::

        engine.apply_grouped
          engine.prepare_packed        (B of them: the log ∪ delta concat,
                                        written into the tree's row)
          grouped.stack                (the frame is the stack: counts
                                        only, grouped.docs = B,
                                        grouped.rows_stacked = B x N,
                                        grouped.rows_live = the candidate
                                        rows, grouped.rows_in_place = those
                                        written straight into the frame,
                                        grouped.rows_restacked = rows
                                        copied into it after the prepares)
          merge.materialize            (merge.h2d, the stages)
          engine.finish_packed         (B of them: read-back and commit)
    """
    trees, deltas = list(trees), list(deltas)
    if not trees or len(trees) != len(deltas):
        raise ValueError(f"{len(deltas)} deltas for {len(trees)} trees")
    dev = trees[0].device
    if any(t.device != dev for t in trees):
        raise ValueError("a grouped merge runs on one device")
    for t, d in zip(trees, deltas):
        if not t.packed_route(d.num_ops):
            raise ValueError(f"a delta of {d.num_ops} ops does not take "
                             f"the bulk route on a {t.log_length}-op log")
    errors: List[Optional[CRDTError]] = [None] * len(trees)
    with profiling.span("engine.apply_grouped"):
        t0 = time.perf_counter()
        shapes = [packed_mod.union_shape([t.packed_state(), d])
                  for t, d in zip(trees, deltas)]
        n = max(cap for cap, _ in shapes)
        frame = packed_mod.frame(len(trees), n,
                                 max(width for _, width in shapes))
        aligned = [t.prepare_packed(d, out={k: v[i]
                                            for k, v in frame.items()})
                   for i, (t, d) in enumerate(zip(trees, deltas))]
        with profiling.span("grouped.stack"):
            profiling.count("grouped.docs", len(trees))
            profiling.count("grouped.rows_stacked", len(trees) * n)
            profiling.count("grouped.rows_live",
                            sum(p.num_ops for p in aligned))
            profiling.count("grouped.rows_in_place", sum(
                p.num_ops for p in aligned if p.kind.base is frame["kind"]))
            profiling.count("grouped.rows_restacked", 0)
        t1 = time.perf_counter()
        btab = mesh_mod.batched_materialize(frame, device=dev)
        if times is not None:
            times["prepare_ms"] = (t1 - t0) * 1e3
            times["launch_ms"] = (time.perf_counter() - t1) * 1e3
        for i, (t, d) in enumerate(zip(trees, deltas)):
            def commit(i=i, t=t, d=d):
                try:
                    t.finish_packed(d, aligned[i],
                                    mesh_mod.doc_table(btab, i))
                except CRDTError as e:
                    errors[i] = e
                    raise
            each(i, commit)
    return errors


def init(replica: int, max_depth: int = DEFAULT_MAX_DEPTH,
         device=None) -> TpuTree:
    """Build a replica whose bulk merges run on ``device`` (default the
    card; it raises without one)."""
    return TpuTree(replica, max_depth=max_depth, device=device)


restore = TpuTree.restore
