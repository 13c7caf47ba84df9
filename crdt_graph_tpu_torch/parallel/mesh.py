"""Device meshes and the mesh forms of the merge: the port of
``crdt_graph_tpu.parallel.mesh``.

Two orthogonal mesh axes, composable into a 2-D mesh, as in the
reference:

- ``docs`` — independent documents (trees).  A server merging many
  documents batches them on a leading axis; merges never communicate
  across documents, so each document's slice of the batched table is
  exactly its own single merge.
- ``ops`` — parallelism *within* one merge: the packed op axis is split
  into ``mesh.shape["ops"]`` contiguous shards.

A :class:`Mesh` is a ``(docs, ops)`` grid of ``torch.device``s.  A
device may repeat: ``make_mesh(1, 8, devices=["cuda:0"] * 8)`` is eight
*logical* devices of one card (shard i runs its work on its grid entry,
which is the same card for every i), the pattern of
``parallel.opsaxis``; on a host with several cards the same code puts
the shards on distinct cards.

The reference partitions with XLA (input shardings on the whole-array
kernel, ``vmap`` over documents with its Pallas kernels off).  The port
has no SPMD partitioner, so each mesh form is written out:

- :func:`sharded_materialize` — one merge with the op axis sharded over
  the mesh's ``ops`` row: the port's explicit ops-axis merge
  (``parallel.opsaxis``), whose joins are written out;
- :func:`batched_materialize` — B independent documents (``[B, N]``
  columns) merged as ONE merge over a leading document axis, the
  reference's vmapped body: one chain of dispatches and host reads for
  the batch, each kernel launched once in its batched form
  (``ops.merge._materialize`` on ``[B, N]`` columns).  With ``device=``
  (the serving form) the batch runs on that device; with a mesh, each
  docs row's documents run as one batched merge on the row's first
  device (consecutive rows on one device as one batch), or, with
  ``shard_ops_axis=True``, one ops-axis merge a document over the whole
  row.  The table carries the leading document axis, as the
  reference's batched table does.

  A batch is cut into sub-batches of at most :data:`BATCH_ROWS` op rows
  (``BATCH_ROWS // N`` documents, at least one), merged one after
  another and concatenated: a merge's intermediates peak at a few
  hundred bytes an op row (0.49 GB over the columns for 16 documents of
  65,536 ops on an H100), so the cap holds a batch near 8 GB, far
  inside the card's memory.  The kernels' int32 index types bound each
  document (the 2^30 slot guard), never the batch: every batched
  kernel offsets a document's rows by 64-bit arithmetic after clamping
  its index to the document's own rows.  The rule is fixed, not a
  setting.

The explicitly partitioned resolve (the reference's ``shard_map``
schedule) is ``parallel.shard``; the multi-process mesh is
``parallel.distributed``.

Entry points:

- :func:`make_mesh` / :func:`logical_devices` — a mesh, and n logical
  devices of one card (or of the CPU).
- :func:`sharded_materialize`, :func:`batched_materialize`,
  :func:`materialize_each` (one table per document, each a view of the
  one batched table), :func:`doc_table` (document i's slice).
- :func:`stack_packed` / :func:`stack_aligned` — per-document packed
  ops → ``[B, N]`` numpy columns (aligned: every batch re-padded to the
  shared capacity first).
- :class:`LingerBatcher` — the cross-caller accumulation window (the
  merge worker's epochs, mergetier/worker.py).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..codec.packed import PackedOps, with_capacity
from ..codec.packed import pad_arrays as packed_pad_arrays
from ..ops import merge as merge_mod
from ..ops.merge import FIELDS, NodeTable
from ..utils import profiling
from . import opsaxis
from .opsaxis import _host

DOCS_AXIS = "docs"
OPS_AXIS = "ops"

# the position hints the default (join) body drops, as the reference's
# batched body does: its hinted path's ``lax.cond`` would run both
# branches under ``vmap``, so it joins instead
POS_HINTS = ("parent_pos", "anchor_pos", "target_pos")

# the most op rows (documents times rows) one batched merge takes; a
# larger batch is merged in sub-batches of BATCH_ROWS // N documents
# (module docstring)
BATCH_ROWS = 1 << 24


class Mesh:
    """A ``(docs, ops)`` grid of ``torch.device``s (entries may repeat:
    logical devices).  ``shape`` is ``{"docs": rows, "ops": columns}``.

    A mesh over several processes (``parallel.distributed``) also says
    which process owns each docs row (``row_process``) and which process
    this is; a single-process mesh owns every row."""

    axis_names = (DOCS_AXIS, OPS_AXIS)

    def __init__(self, grid: Sequence[Sequence], row_process=None,
                 process_index: int = 0):
        self.devices = [[torch.device(d) for d in row] for row in grid]
        width = len(self.devices[0]) if self.devices else 0
        if not width or any(len(r) != width for r in self.devices):
            raise ValueError("a mesh is a non-empty rectangular grid")
        self.process_index = int(process_index)
        self.row_process = [self.process_index] * len(self.devices) \
            if row_process is None else [int(p) for p in row_process]
        if len(self.row_process) != len(self.devices):
            raise ValueError("one owning process per docs row")

    @property
    def shape(self) -> Dict[str, int]:
        return {DOCS_AXIS: len(self.devices), OPS_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def ops_row(self, i: int = 0) -> List[torch.device]:
        """The ops-axis devices of docs row ``i``."""
        return list(self.devices[i])

    def local_rows(self) -> List[int]:
        """The docs rows this process owns."""
        return [i for i, p in enumerate(self.row_process)
                if p == self.process_index]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[[str(d) for d in r] for r in self.devices]})")


def visible_devices() -> List[torch.device]:
    """Every visible card (none without CUDA)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def logical_devices(n: int, device=None) -> List[torch.device]:
    """``n`` devices for a mesh on ``device`` (default: the card).  The
    default card (``None`` or ``"cuda"``) spreads them over the visible
    cards, repeating where there are fewer than ``n``; any other device
    is repeated ``n`` times (``["cpu"] * n``, ``["cuda:0"] * n``)."""
    dev = merge_mod.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        return [torch.device("cuda", i % count) for i in range(n)]
    return [dev] * n


def make_mesh(n_docs: int = 1, n_ops: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``(docs, ops)`` mesh over ``n_docs * n_ops`` devices: the first
    ones of ``devices`` (default: every visible card).  Raises
    ``ValueError`` when there are fewer."""
    if devices is None:
        devices = visible_devices()
    devices = list(devices)
    need = n_docs * n_ops
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh([devices[r * n_ops:(r + 1) * n_ops] for r in range(n_docs)])


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def sharded_materialize(ops: Dict, mesh: Mesh) -> NodeTable:
    """One merge with the op axis sharded over the mesh's ``ops`` row.

    The reference pads the columns to a multiple of the axis, places them
    with an ops-axis sharding and lets XLA partition the whole-array
    merge.  Here the padded columns go through the port's explicit
    ops-axis merge (``opsaxis.materialize(..., k=mesh.shape["ops"])``)
    with shard i on the first docs row's device i, in the reference's
    default hint mode (verified hints, the sort+join where they fail).
    The table lies on that row's first device and equals
    ``merge.materialize`` of the same padded columns, field for field."""
    k = mesh.shape[OPS_AXIS]
    row = mesh.ops_row(0)
    cols = {c: _host(v) for c, v in ops.items()}
    padded = packed_pad_arrays(cols, round_up(cols["kind"].shape[0], k))
    return opsaxis.materialize(padded, k=k, hints=None, device=row[0],
                               devices=row)


@dataclasses.dataclass
class GlobalDocs:
    """A fleet-wide document batch as one process holds it
    (``distributed.host_local_docs_to_global``): this process's
    ``[B_local, N]`` columns, the global batch size and the global index
    of its first document."""

    local: Dict[str, np.ndarray]
    global_b: int
    offset: int


def _merge_docs(ops: Dict, keys, hints: str, dev) -> NodeTable:
    """One batched merge of ``[B, N]`` columns on ``dev``: sub-batches
    of at most :data:`BATCH_ROWS` rows, concatenated."""
    b, n = (int(x) for x in ops["kind"].shape[:2])
    per = max(1, BATCH_ROWS // max(n, 1))
    parts = []
    for lo in range(0, b, per):
        sub = {k: ops[k][lo:lo + per] for k in keys}
        parts.append(merge_mod._materialize(
            sub, hints, dev, merge_mod.host_no_deletes(sub["kind"])))
    if len(parts) == 1:
        return parts[0]
    return NodeTable(**{f: torch.cat([getattr(t, f) for t in parts])
                        for f in FIELDS})


def _hints(cols, exhaustive_hints: bool):
    """The hint mode and the columns of the batched body: the join leg
    without the position hints (the reference's default body), or the
    exhaustive leg with every column."""
    keys = [k for k in cols if exhaustive_hints or k not in POS_HINTS]
    return ("exhaustive" if exhaustive_hints else "join"), keys


def materialize_each(ops: Dict[str, np.ndarray], device=None,
                     exhaustive_hints: bool = False) -> List[NodeTable]:
    """The batched merge of ``[B, N]`` columns (:func:`stack_packed`) as
    one :class:`NodeTable` per document: views of the one batched table
    (:func:`doc_table`), each at the shared capacity ``N``, on
    ``device``.  Hint modes as :func:`batched_materialize`."""
    btab = batched_materialize(ops, exhaustive_hints=exhaustive_hints,
                               device=device)
    return [doc_table(btab, i) for i in range(int(btab.status.shape[0]))]


def _mesh_tables(ops, mesh: Mesh, shard_ops_axis: bool,
                 exhaustive_hints: bool) -> List[NodeTable]:
    """The mesh form: document i (global index) on docs row
    ``i // (B / docs)``; only this process's rows are merged, each row's
    documents as one batched merge on the row's first device, and the
    documents of consecutive rows that start on the same device (logical
    devices of one card) as one batch (with ``shard_ops_axis``, one
    ops-axis merge a document over its row).  Returns the batched tables
    in document order."""
    if isinstance(ops, GlobalDocs):
        cols, b, offset = ops.local, ops.global_b, ops.offset
    else:
        cols, b, offset = ops, int(ops["kind"].shape[0]), 0
    n_docs, n_ops = mesh.shape[DOCS_AXIS], mesh.shape[OPS_AXIS]
    if b % n_docs != 0:
        raise ValueError(f"doc axis {b} not divisible by mesh docs axis "
                         f"{n_docs}; pad the document batch")
    if shard_ops_axis and cols["kind"].shape[1] % n_ops != 0:
        raise ValueError(f"op axis {cols['kind'].shape[1]} not divisible "
                         f"by mesh ops axis {n_ops}; pad the columns")
    per = b // n_docs
    hints, keys = _hints(cols, exhaustive_hints)
    mine = set(mesh.local_rows())
    n_local = int(cols["kind"].shape[0])
    tables = []
    lo = 0
    while lo < n_local:
        r = (offset + lo) // per
        if r not in mine:
            raise ValueError(f"document {offset + lo} lies on docs row {r}, "
                             f"which process {mesh.row_process[r]} owns")
        hi = min(n_local, (r + 1) * per - offset)
        row = mesh.ops_row(r)
        # the next rows' documents join the batch while their rows
        # start on the same device (logical devices of one card)
        while not shard_ops_axis and hi < n_local:
            r2 = (offset + hi) // per
            if r2 not in mine or mesh.ops_row(r2)[0] != row[0]:
                break
            hi = min(n_local, (r2 + 1) * per - offset)
        if shard_ops_axis:
            for i in range(lo, hi):
                one = {k: _host(cols[k][i]) for k in keys}
                t = opsaxis.materialize(one, k=n_ops, hints=hints,
                                        device=row[0], devices=row)
                tables.append(NodeTable(**{f: getattr(t, f)[None]
                                           for f in FIELDS}))
        else:
            tables.append(_merge_docs(
                {k: _host(cols[k][lo:hi]) for k in keys}, keys, hints,
                row[0]))
        lo = hi
    if not tables:
        raise ValueError("batched_materialize needs at least one document")
    return tables


def batched_materialize(ops, mesh: Optional[Mesh] = None,
                        shard_ops_axis: bool = False,
                        exhaustive_hints: bool = False,
                        device=None) -> NodeTable:
    """B independent documents' ``[B, N]`` columns merged as one batched
    merge (module docstring): one :class:`NodeTable` whose every field
    has the leading document axis — the reference's batched table, field
    for field.

    With ``mesh`` (the reference's form): a batch the docs axis does not
    divide raises ``ValueError``; each docs row's documents merge on
    that row, and with ``shard_ops_axis`` each document's merge is the
    ops-axis merge over the row (one merge a document).  ``ops`` may be
    a :class:`GlobalDocs`: then only this process's documents merge, and
    the table holds them (global rows ``offset`` on).  Without ``mesh``
    the batch merges on ``device`` (default: the card).  The table lies
    on the first document's device.

    ``exhaustive_hints=True`` opts into the hinted resolution — ONLY for
    batches whose link-hint coverage the caller vouches for
    (pack/stack_packed provenance); the default drops the position hints
    and joins, which is correct for any input."""
    if mesh is None:
        dev = merge_mod.resolve_device(device)
        if int(ops["kind"].shape[0]) < 1:
            raise ValueError("batched_materialize needs at least one "
                             "document")
        hints, keys = _hints(ops, exhaustive_hints)
        return _merge_docs(ops, keys, hints, dev)
    if device is not None:
        raise ValueError("give batched_materialize a mesh or a "
                         "device, not both")
    tables = _mesh_tables(ops, mesh, shard_ops_axis, exhaustive_hints)
    if len(tables) == 1:
        return tables[0]
    home = tables[0].status.device
    return NodeTable(**{f: torch.cat([getattr(t, f).to(home)
                                      for t in tables])
                        for f in FIELDS})


def doc_table(btab: NodeTable, i: int) -> NodeTable:
    """Document ``i``'s slice of a :func:`batched_materialize` table
    (views, no copy)."""
    return NodeTable(**{f: getattr(btab, f)[i] for f in FIELDS})


def stack_aligned(batches: Sequence[PackedOps]
                  ) -> "tuple[Dict[str, np.ndarray], list]":
    """:func:`stack_packed` plus per-document capacity alignment: every
    batch is first re-padded to the SHARED capacity (codec.packed
    ``with_capacity``) and the aligned PackedOps are returned alongside
    the stacked arrays.  The serving scheduler commits each document
    against its slice of the batched table, so the per-document columns
    it parks must have the same row capacity the table was materialized
    at — stacking alone would leave them inconsistent."""
    shared = max(p.capacity for p in batches)
    aligned = [with_capacity(p, shared) for p in batches]
    return stack_packed(aligned), aligned


class LingerBatcher:
    """Cross-caller batch accumulation window for the batched merge.

    Many threads each hold ONE item (a document's prepared candidate
    set) and want it materialized; a wide batched merge
    amortizes launch overhead across all of them, but only if their
    arrivals meet in the same launch.  :meth:`submit` parks the caller
    while a shared window fills: the FIRST arrival becomes the epoch's
    leader and waits up to ``linger_s`` for co-travellers, launching
    early the moment ``max_width`` items are aboard; everyone else
    rides, and every submitter gets exactly its own item's result back.
    A failed launch fails the WHOLE epoch's submitters (each caller
    falls back on its own).

    ``launch`` receives the epoch's item list and must return one
    result per item, in order.  It runs on the leader's thread; the
    batcher itself never touches the card, so which thread launches is
    the launch callable's business, not ours.  The leader's linger wait
    is the span ``mergetier.batch_wait`` (``utils.profiling``).
    """

    def __init__(self, launch: Callable[[List[Any]], List[Any]],
                 linger_s: float = 0.002, max_width: int = 16):
        self._launch = launch
        self.linger_s = max(0.0, float(linger_s))
        self.max_width = max(1, int(max_width))
        self._cv = threading.Condition()
        self._epoch = 0
        self._items: List[Any] = []          # current epoch's cargo
        self._done: Dict[int, tuple] = {}    # epoch -> (results, error)
        self._riders: Dict[int, int] = {}    # epoch -> riders not yet woken
        self._closed = False
        # telemetry (read under the cv by stats())
        self.launches = 0
        self.items_in = 0
        self.full_launches = 0               # width cap hit (no linger)
        self.linger_waits = 0                # epochs that waited the window

    def submit(self, item: Any) -> Any:
        """Park until this item's epoch launches; returns its result.
        Raises whatever the epoch's launch raised (every rider sees the
        same error) or ``RuntimeError`` after :meth:`close`."""
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher closed")
            epoch = self._epoch
            self._items.append(item)
            self.items_in += 1
            index = len(self._items) - 1
            leader = index == 0
            if not leader and len(self._items) >= self.max_width:
                # cap reached: wake the lingering leader early
                self._cv.notify_all()
            if leader:
                deadline = time.monotonic() + self.linger_s
                waited = False
                with profiling.span("mergetier.batch_wait"):
                    while (len(self._items) < self.max_width
                           and not self._closed):
                        remain = deadline - time.monotonic()
                        if remain <= 0:
                            break
                        waited = True
                        self._cv.wait(remain)
                cargo, self._items = self._items, []
                self._epoch += 1
                if waited:
                    self.linger_waits += 1
                if len(cargo) >= self.max_width:
                    self.full_launches += 1
            else:
                while epoch not in self._done and not self._closed:
                    self._cv.wait(1.0)
                if epoch not in self._done:
                    raise RuntimeError("batcher closed mid-epoch")
                results, error = self._done[epoch]
                # last rider out sweeps the epoch's parking spot
                self._rider_done(epoch)
                if error is not None:
                    raise error
                return results[index]
        # leader, outside the lock: run the launch for the whole epoch
        results: Optional[List[Any]] = None
        error: Optional[BaseException] = None
        try:
            results = self._launch(cargo)
            if results is None or len(results) != len(cargo):
                raise RuntimeError(
                    f"launch returned {0 if results is None else len(results)}"
                    f" results for {len(cargo)} items")
        except BaseException as e:   # noqa: BLE001 — every rider must
            # wake with THIS error, whatever class it is
            error = e
        with self._cv:
            self.launches += 1
            self._done[epoch] = (results, error)
            self._riders[epoch] = len(cargo) - 1
            if self._riders[epoch] == 0:
                del self._done[epoch], self._riders[epoch]
            self._cv.notify_all()
        if error is not None:
            raise error
        return results[0]

    def _rider_done(self, epoch: int) -> None:
        # requires self._cv
        self._riders[epoch] -= 1
        if self._riders[epoch] == 0:
            del self._done[epoch], self._riders[epoch]

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            return {"launches": self.launches,
                    "items_in": self.items_in,
                    "full_launches": self.full_launches,
                    "linger_waits": self.linger_waits,
                    "linger_ms": round(self.linger_s * 1e3, 3),
                    "max_width": self.max_width,
                    "pending": len(self._items)}


def stack_packed(batches: Sequence[PackedOps]) -> Dict[str, np.ndarray]:
    """Stack per-document packed columns (``PackedOps.columns()``) into
    ``[B, N]`` arrays (N = max, pad-extended; path planes widened to the
    widest depth bucket) for :func:`batched_materialize`, whose
    exhaustive merge derives the slot hints on its device."""
    n = max(p.capacity for p in batches)
    width = max(p.max_depth for p in batches)
    per = []
    for p in batches:
        arrs = p.columns()
        if arrs["paths"].shape[1] < width:
            wide = np.zeros((arrs["paths"].shape[0], width),
                            dtype=arrs["paths"].dtype)
            wide[:, :arrs["paths"].shape[1]] = arrs["paths"]
            arrs["paths"] = wide
        per.append(packed_pad_arrays(arrs, n))
    return {k: np.stack([d[k] for d in per]) for k in per[0]}
