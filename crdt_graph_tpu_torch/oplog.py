"""The operation log: the applied-op history as in-memory columnar
segments with reference-stable read views.

The port of the reference package's ``oplog`` for its hot tier — every
segment lives in memory: object runs for host-path edits, ``PackedOps``
row ranges for bulk ingest.  The contract is the reference's: a
chronological applied-ops-only history, ``operations_since`` suffix
semantics (inclusive terminator), truncate rollback that replaces
segments instead of mutating them, and immutable :class:`LogView`
snapshots whose anti-entropy windows are byte- and meta-identical to
``engine.packed_since_window`` over the full packing.

Tiering (cold segments, the chunked checkpoint base, spill, GC, scrub,
``persist``/``open_dir``) is not part of this package yet:
:meth:`OpLog.enable_tiering` raises, naming the ROADMAP item.  Without
it nothing mutates the log concurrently with its owner, so the
reference's lock and live-view bookkeeping (which guard its background
GC) are left out.
"""
from __future__ import annotations

from typing import Any, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np

from .codec import packed as packed_mod
from .codec.packed import DEFAULT_MAX_DEPTH, KIND_ADD, PackedOps
from .core.operation import Add, Batch, Operation

EMPTY_BATCH_BYTES = b'{"op":"batch","ops":[]}'
TIERING_QUEUE = ("ROADMAP.md, 'PyTorch/CUDA port queue' (durability: op-log "
                 "tiering, the WAL, matz, checkpoint_tiered)")


class PackedBatch(Batch):
    """A ``Batch`` whose ``ops`` materialize lazily from packed columns.

    The bulk ingest result (``TpuTree.last_operation`` after a columnar
    apply): consumers that only COUNT read :attr:`num_leaves`; consumers
    that need objects touch :attr:`ops` and pay the materialization
    exactly once.  Equality compares as a ``Batch`` of the same ops,
    across the class boundary.
    """

    def __init__(self, packed: PackedOps, start: int = 0,
                 stop: Optional[int] = None):
        stop = packed.num_ops if stop is None else stop
        object.__setattr__(self, "_packed", packed)
        object.__setattr__(self, "_start", start)
        object.__setattr__(self, "_stop", stop)
        object.__setattr__(self, "_ops", None)

    @property
    def num_leaves(self) -> int:
        return self._stop - self._start

    @property
    def ops(self) -> tuple:
        if self._ops is None:
            object.__setattr__(self, "_ops", tuple(
                packed_mod.unpack_rows(self._packed, self._start,
                                       self._stop)))
        return self._ops

    def __eq__(self, other):
        if isinstance(other, Batch):
            return self.ops == tuple(other.ops)
        return NotImplemented

    def __hash__(self):
        return hash((self.ops,))

    def __repr__(self):
        return (f"PackedBatch({self.num_leaves} ops"
                f"{', materialized' if self._ops is not None else ''})")


class ViewSpanBatch(Batch):
    """A ``Batch`` over a log-position span of a :class:`LogView`,
    materialized lazily (the reference's restore-side twin of
    :class:`PackedBatch`)."""

    def __init__(self, view: "LogView", start: int, stop: int):
        object.__setattr__(self, "_view", view)
        object.__setattr__(self, "_start", start)
        object.__setattr__(self, "_stop", stop)
        object.__setattr__(self, "_ops", None)

    @property
    def num_leaves(self) -> int:
        return self._stop - self._start

    @property
    def ops(self) -> tuple:
        if self._ops is None:
            object.__setattr__(self, "_ops", tuple(
                self._view.materialize(self._start, self._stop)))
        return self._ops

    def __eq__(self, other):
        if isinstance(other, Batch):
            return self.ops == tuple(other.ops)
        return NotImplemented

    def __hash__(self):
        return hash((self.ops,))

    def __repr__(self):
        return (f"ViewSpanBatch([{self._start}, {self._stop})"
                f"{', materialized' if self._ops is not None else ''})")


class _PackedSeg:
    """A row range of an in-memory PackedOps, as one segment."""

    __slots__ = ("packed", "start", "stop")

    def __init__(self, packed: PackedOps, start: int, stop: int):
        self.packed = packed
        self.start = start
        self.stop = stop

    def __len__(self) -> int:
        return self.stop - self.start


Segment = Union[List[Operation], _PackedSeg]

# one view part: (tag, payload, lo, hi, gstart) — tag "obj" (list of
# ops) or "packed" (in-memory PackedOps rows); lo/hi index INTO the
# payload, gstart is the part's global log position
_ViewPart = Tuple[str, Any, int, int, int]


class LogView:
    """An immutable snapshot of the log's segment layout.  Everything a
    read surface needs resolves against it: ``operations_since``
    suffixes, bounded anti-entropy windows (byte-identical to
    ``engine.packed_since_window`` over the full packing), full-column
    reassembly.  The log only ever REPLACES segments, so a view keeps
    serving the rows it captured."""

    __slots__ = ("parts", "length", "last_add_pos", "max_depth",
                 "_starts", "_packed_all")

    def __init__(self, parts: Tuple[_ViewPart, ...], length: int,
                 last_add_pos: Optional[int],
                 max_depth: int = DEFAULT_MAX_DEPTH):
        self.parts = parts
        self.length = length
        self.last_add_pos = last_add_pos
        self.max_depth = max_depth
        self._starts = np.asarray([p[4] for p in parts], dtype=np.int64)
        self._packed_all: Optional[PackedOps] = None

    @property
    def num_segments(self) -> int:
        return len(self.parts)

    def _first_part(self, pos: int) -> int:
        if not len(self._starts):
            return 0
        return max(0, int(np.searchsorted(self._starts, pos,
                                          side="right")) - 1)

    @staticmethod
    def _part_ops(tag: str, payload, lo: int, hi: int) -> List[Operation]:
        if tag == "obj":
            return list(payload[lo:hi])
        return packed_mod.unpack_rows(payload, lo, hi)

    def _part_packed(self, tag: str, payload, lo: int, hi: int
                     ) -> PackedOps:
        if tag == "obj":
            return packed_mod.pack(list(payload[lo:hi]),
                                   max_depth=self.max_depth)
        if lo == 0 and hi == payload.num_ops:
            return payload
        return packed_mod.select_rows(payload, np.arange(lo, hi))

    def _overlaps(self, start: int, stop: int):
        """Yield ``(tag, payload, plo, phi)`` for the parts overlapping
        global rows [start, stop), with lo/hi clipped to the overlap."""
        for k in range(self._first_part(start), len(self.parts)):
            tag, payload, lo, hi, g = self.parts[k]
            if g >= stop:
                break
            s = max(start - g, 0)
            e = min(stop - g, hi - lo)
            if s < e:
                yield tag, payload, lo + s, lo + e

    # -- object reads -----------------------------------------------------

    def iter_ops(self) -> Iterator[Operation]:
        for tag, payload, lo, hi, _ in self.parts:
            yield from self._part_ops(tag, payload, lo, hi)

    def materialize(self, start: int, stop: int) -> List[Operation]:
        start = max(start, 0)
        stop = min(stop, self.length)
        out: List[Operation] = []
        for tag, payload, lo, hi in self._overlaps(start, stop):
            out.extend(self._part_ops(tag, payload, lo, hi))
        return out

    # -- position queries -------------------------------------------------

    def index_of_add(self, ts: int) -> Optional[int]:
        """Global log position of the Add with timestamp ``ts`` (the
        ``operations_since`` terminator) or None."""
        for tag, payload, lo, hi, g in self.parts:
            if tag == "obj":
                for j in range(lo, hi):
                    op = payload[j]
                    if isinstance(op, Add) and op.ts == ts:
                        return g + (j - lo)
            else:
                hit = payload.index().get(ts)
                if hit is not None and lo <= hit < hi:
                    return g + (hit - lo)
        return None

    def kinds(self, start: int, stop: int) -> np.ndarray:
        """op kinds for global rows [start, stop)."""
        chunks: List[np.ndarray] = []
        for tag, payload, lo, hi in self._overlaps(start, stop):
            if tag == "obj":
                chunks.append(np.fromiter(
                    (KIND_ADD if isinstance(payload[j], Add)
                     else packed_mod.KIND_DELETE for j in range(lo, hi)),
                    dtype=np.int8, count=hi - lo))
            else:
                chunks.append(np.asarray(payload.kind[lo:hi],
                                         dtype=np.int8))
        if not chunks:
            return np.zeros(0, np.int8)
        return np.concatenate(chunks)

    def next_add_at_or_after(self, pos: int) -> Optional[int]:
        """Global position of the first Add at or after ``pos``."""
        for k in range(self._first_part(pos), len(self.parts)):
            tag, payload, lo, hi, g = self.parts[k]
            rel_from = lo + max(0, pos - g)
            if rel_from >= hi:
                continue
            if tag == "obj":
                for j in range(rel_from, hi):
                    if isinstance(payload[j], Add):
                        return g + (j - lo)
            else:
                idx = np.nonzero(payload.kind[rel_from:hi] == KIND_ADD)[0]
                if len(idx):
                    return g + (rel_from + int(idx[0]) - lo)
        return None

    # -- column reassembly ------------------------------------------------

    def slice_packed(self, start: int, stop: int) -> PackedOps:
        """Rows [start, stop) as one self-contained PackedOps, row for
        row what slicing the full packing would give."""
        start = max(start, 0)
        stop = min(stop, self.length)
        pieces = [self._part_packed(tag, payload, lo, hi)
                  for tag, payload, lo, hi in self._overlaps(start, stop)]
        if not pieces:
            return packed_mod.pack([], max_depth=self.max_depth)
        return packed_mod.concat_many(pieces)

    def to_packed(self) -> PackedOps:
        """The whole view as one PackedOps (cached on the view)."""
        if self._packed_all is None:
            self._packed_all = self.slice_packed(0, self.length)
        return self._packed_all

    # -- wire serving -----------------------------------------------------

    def _single_full_packed(self) -> Optional[PackedOps]:
        if len(self.parts) == 1 and self.parts[0][0] == "packed":
            _, p, lo, hi, _ = self.parts[0]
            if lo == 0 and hi == p.num_ops:
                return p
        return None

    def since_bytes(self, since: int) -> bytes:
        """Wire JSON for ``operations_since(since)`` — byte-identical to
        ``engine.packed_since_bytes`` over the full packing."""
        from . import engine as engine_mod
        p = self._single_full_packed()
        if p is not None:
            return engine_mod.packed_since_bytes(p, since)
        if since == 0:
            start = 0
        else:
            start = self.index_of_add(since)
            if start is None or start >= self.length:
                return EMPTY_BATCH_BYTES
        sub = self.to_packed() if start == 0 \
            else self.slice_packed(start, self.length)
        return engine_mod.packed_since_bytes(sub, 0)

    def window(self, since: int, limit: int = 0):
        """Bounded, resumable anti-entropy window over the view —
        ``(wire_bytes, {"found", "more", "next_since", "count"})``,
        byte- and meta-identical to ``engine.packed_since_window`` over
        the full packing (the trimming rules mirror it clause for
        clause)."""
        from . import engine as engine_mod
        p = self._single_full_packed()
        if p is not None:
            return engine_mod.packed_since_window(p, since, limit)
        start, stop, early = self._window_bounds(since, limit)
        if early is not None:
            return EMPTY_BATCH_BYTES, early
        sub = self.slice_packed(start, stop)
        body = engine_mod.packed_since_bytes(sub, 0)
        served = np.nonzero(sub.kind[:sub.num_ops] == KIND_ADD)[0]
        next_since = int(sub.ts[int(served[-1])]) if len(served) else None
        return body, {"found": True, "more": stop < self.length,
                      "next_since": next_since, "count": stop - start}

    def _window_bounds(self, since: int, limit: int):
        """The window's row bounds: ``(start, stop, None)``, or
        ``(0, 0, meta)`` when the answer is the empty batch."""
        n = self.length
        if since == 0:
            start = 0
        else:
            start = self.index_of_add(since)
            if start is None or start >= n:
                return 0, 0, {"found": False, "more": False,
                              "next_since": None, "count": 0}
        if start >= n:
            return 0, 0, {"found": True, "more": False,
                          "next_since": None, "count": 0}
        stop = n
        if 0 < limit < n - start:
            window_adds = np.nonzero(
                self.kinds(start, start + limit) == KIND_ADD)[0]
            # a resumed window whose only Add is the inclusive
            # terminator extends through the next Add instead of
            # re-serving itself forever
            if len(window_adds) and (since == 0
                                     or int(window_adds[-1]) > 0):
                stop = start + int(window_adds[-1]) + 1
            else:
                nxt = self.next_add_at_or_after(start + limit)
                stop = nxt + 1 if nxt is not None else n
            if stop < n and (self.last_add_pos is None
                             or self.last_add_pos < stop):
                # everything past the trimmed window is deletes: serve
                # the tail now (no later Add would carry it)
                stop = n
        return start, stop, None

    def window_plan(self, since: int, limit: int):
        """The zero-copy serving plan of the reference — ``(plan,
        missing)`` — exists only for windows that land entirely on cold
        segments with wire sidecars.  Every segment here is in memory,
        so the plan is always None and the buffered :meth:`window`
        serves."""
        return None, []


class OpLog:
    """Chronological applied-op log over in-memory segments (see module
    docstring)."""

    def __init__(self, ops: Iterable[Operation] = ()):
        self._segs: List[Segment] = []
        self._len = 0
        self._last_add: Optional[int] = None
        ops = list(ops)
        if ops:
            self.extend(ops)

    def enable_tiering(self, dir: str, **kw) -> "OpLog":
        raise NotImplementedError(
            f"op-log tiering is not ported yet; see {TIERING_QUEUE}")

    @property
    def tiering_enabled(self) -> bool:
        return False

    # -- writers ----------------------------------------------------------

    def append(self, op: Operation) -> None:
        if self._segs and isinstance(self._segs[-1], list):
            self._segs[-1].append(op)
        else:
            self._segs.append([op])
        if isinstance(op, Add):
            self._last_add = self._len
        self._len += 1

    def extend(self, ops: Iterable[Operation]) -> None:
        ops = list(ops)
        if not ops:
            return
        if self._segs and isinstance(self._segs[-1], list):
            self._segs[-1].extend(ops)
        else:
            self._segs.append(ops)
        for j in range(len(ops) - 1, -1, -1):
            if isinstance(ops[j], Add):
                self._last_add = self._len + j
                break
        self._len += len(ops)

    def extend_packed(self, p: PackedOps, start: int = 0,
                      stop: Optional[int] = None) -> None:
        """Append rows ``[start, stop)`` of ``p`` as one column segment —
        O(1) plus an O(delta) kind scan for the last-Add cursor; no
        objects are built."""
        stop = p.num_ops if stop is None else stop
        if stop <= start:
            return
        self._segs.append(_PackedSeg(p, start, stop))
        adds = np.nonzero(p.kind[start:stop] == KIND_ADD)[0]
        if len(adds):
            self._last_add = self._len + int(adds[-1])
        self._len += stop - start

    def truncate(self, n: int) -> None:
        """Drop everything at index ``n`` and after (batch rollback).
        Copy-on-truncate: affected segments are REPLACED, never mutated
        in place, so views keep their frozen extents."""
        if n >= self._len:
            return
        n = max(0, n)
        base = 0
        for k, seg in enumerate(self._segs):
            ln = len(seg)
            if base + ln > n:
                keep = n - base
                if keep == 0:
                    del self._segs[k:]
                elif isinstance(seg, list):
                    self._segs[k] = seg[:keep]
                    del self._segs[k + 1:]
                else:
                    self._segs[k] = _PackedSeg(seg.packed, seg.start,
                                               seg.start + keep)
                    del self._segs[k + 1:]
                break
            base += ln
        self._len = n
        if self._last_add is not None and self._last_add >= n:
            self._recompute_last_add()

    def _recompute_last_add(self) -> None:
        g = self._len
        for seg in reversed(self._segs):
            ln = len(seg)
            g -= ln
            if isinstance(seg, list):
                for j in range(ln - 1, -1, -1):
                    if isinstance(seg[j], Add):
                        self._last_add = g + j
                        return
            else:
                idx = np.nonzero(
                    seg.packed.kind[seg.start:seg.stop] == KIND_ADD)[0]
                if len(idx):
                    self._last_add = g + int(idx[-1])
                    return
        self._last_add = None

    # -- views ------------------------------------------------------------

    def view(self, max_depth: int = DEFAULT_MAX_DEPTH) -> LogView:
        """Freeze the current layout into an immutable :class:`LogView`."""
        parts: List[_ViewPart] = []
        g = 0
        for seg in self._segs:
            if isinstance(seg, list):
                parts.append(("obj", seg, 0, len(seg), g))
                g += len(seg)
            else:
                parts.append(("packed", seg.packed, seg.start, seg.stop, g))
                g += seg.stop - seg.start
        return LogView(tuple(parts), g, self._last_add, max_depth)

    # -- readers ----------------------------------------------------------

    def __len__(self) -> int:
        return self._len

    @property
    def num_segments(self) -> int:
        return len(self._segs)

    def __bool__(self) -> bool:
        return self._len > 0

    def __iter__(self) -> Iterator[Operation]:
        return self.view().iter_ops()

    def materialize(self, start: int, stop: int) -> List[Operation]:
        """Operation objects for rows ``[start, stop)``."""
        return self.view().materialize(start, stop)

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(self._len)
            if step != 1:
                raise ValueError("OpLog slices support step 1 only")
            return self.materialize(start, stop)
        if i < 0:
            i += self._len
        if not 0 <= i < self._len:
            raise IndexError(i)
        return self.materialize(i, i + 1)[0]

    def index_of_add(self, ts: int) -> Optional[int]:
        """Log position of the Add with timestamp ``ts`` (the
        ``operations_since`` terminator), or None."""
        return self.view().index_of_add(ts)

    def as_batch(self) -> Batch:
        """The whole log as one Batch — lazily (a PackedBatch over the
        columns) when the log is a single column segment."""
        if len(self._segs) == 1 and not isinstance(self._segs[0], list):
            seg = self._segs[0]
            return PackedBatch(seg.packed, seg.start, seg.stop)
        return Batch(tuple(self.view().iter_ops()))

    def tail_is(self, pb: PackedBatch) -> bool:
        """True iff ``pb`` wraps exactly this log's final segment rows —
        the O(1) identity check behind the binary checkpoint's
        ``last_op_span``."""
        if not self._segs or pb.num_leaves == 0:
            return False
        seg = self._segs[-1]
        return (isinstance(seg, _PackedSeg)
                and seg.packed is pb._packed
                and pb._stop == seg.stop
                and pb._start >= seg.start)

    def to_packed(self, max_depth: int = DEFAULT_MAX_DEPTH) -> PackedOps:
        """The whole log as one PackedOps — object runs pack, column
        segments slice, and ``packed.concat_many`` unions them in one
        allocation (cross-resolving link hints, so the result stays
        vouched when every piece is)."""
        return self.view(max_depth).to_packed()
