"""Cascade operation log: the applied-op history as a three-tier
columnar cascade with reference-stable read views.

The port of the reference package's ``oplog`` (host code, numpy only):
the logical contract (chronological applied-ops-only history,
``operations_since`` suffix semantics, truncate rollback, checkpoint
round trips) is the reference's, over three physical tiers whose files
are byte-identical to the reference's for the same commits — so a tier
directory written by either package opens in the other (pinned by
tests/test_torch_tiering.py).  Nothing here touches the card: cold tiers
stay numpy on the host and page in lazily.

- **hot tail** — the in-memory segments exactly as before (object runs
  for host-path edits, ``PackedOps`` row ranges for bulk ingest).  All
  writers append here; steady-state anti-entropy windows serve from
  here.
- **cold segments** — once the hot tail exceeds a configurable op/byte
  budget (``GRAFT_OPLOG_HOT_OPS``), the oldest hot ops are sealed into
  one packed-npz file each (the ``engine.write_packed_npz`` format) and
  drop out of memory.  Resident per cold segment: only a sorted
  add-timestamp index (8 bytes/add — how ``operations_since``
  terminators resolve without touching disk) and the file descriptor
  row.  A window that genuinely needs cold rows loads the segment
  through a small LRU and pays one ``load_packed_npz`` (typed
  :class:`~crdt_graph_tpu_torch.core.errors.CheckpointError` on a missing or
  corrupt file — never a silent partial log).
- **chunked checkpoint base** — cold segments that the causal-stability
  watermark has cleared fold into a SEQUENCE of bounded base chunks
  ("checkpoint advancement"; ``GRAFT_OPLOG_BASE_CHUNK_OPS``), and the
  folded segment files are deleted ("segment GC").  A fold appends
  chunks and rewrites at most the trailing partial one — O(1) chunks of
  write amplification — and a mid-history catch-up window loads ONLY
  its covering chunks.  Bootstrap then opens base + tail descriptors
  instead of replaying history (:meth:`OpLog.open_dir`).

**Reference-stable views.**  Readers never touch the live tier lists:
:meth:`OpLog.view` freezes the current physical layout into an
immutable :class:`LogView` (the object a published read snapshot
pins), and every mutation — append, spill, compaction,
GC, truncate — REPLACES descriptors instead of mutating shared ones.  A
spill or checkpoint advancement concurrent with an in-flight
anti-entropy window chain therefore never shifts, re-serves, or loses a
window: the chain keeps reading the exact rows its view captured
(spilled hot segments stay resident while a live view references them;
GC defers deleting a segment file while any live view references its
descriptor).  Window answers are byte-identical to the untiered
``engine.packed_since_window`` across every tier seam.

**Causal-stability watermark.**  ``set_stable_mark(pos)`` records the
log position below which every fleet replica has already pulled (the
cluster layer derives it as the min anti-entropy mark over the live
lease table); checkpoint
advancement and segment GC only ever consume rows below it, so no
replica can resume a window chain that needs a collected segment.
Single-node serving uses ``auto_stable`` (everything already applied is
stable — there is no replica to strand, and in-flight readers are
protected by their pinned views).  Until every live peer has pulled at
least once the watermark is 0 and nothing folds.

Nothing is ever dropped LOGICALLY: ``operations_since(0)`` still
serves the full history (loading tiers as needed), fingerprints still
hash the full logical extent, and ``to_packed`` still reassembles the
whole column set — the cascade bounds *resident* memory, not history.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
import weakref
import zipfile
from collections import OrderedDict
from typing import (Any, Callable, Dict, Iterable, Iterator, List,
                    Optional, Tuple, Union)

import numpy as np

from .codec import packed as packed_mod
from .codec.packed import DEFAULT_MAX_DEPTH, KIND_ADD, PackedOps
from .core.errors import CheckpointError
from .core.operation import Add, Batch, Delete, Operation
from .utils import profiling
from .utils.hostenv import env_int as _env_int
from .wal import maybe_crash as _maybe_crash

EMPTY_BATCH_BYTES = b'{"op":"batch","ops":[]}'

# resident-byte accounting constants (documented estimates — the same
# estimator prices tiered and untiered logs, so the memory-bound tests
# and the headline bench compare apples to apples):
_OBJ_OP_BYTES = 200          # one materialized Add/Delete + list slot


def _values_bytes(values: List[Any]) -> int:
    """Estimated resident bytes of a value table: list slots plus a
    sampled mean payload size (values are arbitrary JSON-able objects;
    sampling keeps the estimator O(1) at a million entries)."""
    import sys
    n = len(values)
    if not n:
        return 0
    step = max(1, n // 64)
    sample = values[::step][:64]
    per = sum(sys.getsizeof(v) for v in sample) / len(sample)
    return int(n * (8 + per))


def _packed_resident(p: PackedOps) -> int:
    """Estimated resident bytes of one in-memory PackedOps: device
    columns, derived slot hints, value table, and the cached ts index
    when built."""
    b = 0
    for name in ("kind", "ts", "parent_ts", "anchor_ts", "depth",
                 "paths", "value_ref", "pos", "parent_pos",
                 "anchor_pos", "target_pos", "ts_rank"):
        a = getattr(p, name)
        if a is not None:
            b += a.nbytes
    if p.slot_hints is not None:
        b += sum(a.nbytes for a in p.slot_hints.values())
    b += _values_bytes(p.values)
    if p.ts_index is not None:
        b += p.ts_index.nbytes
    return b


class PackedBatch(Batch):
    """A ``Batch`` whose ``ops`` materialize lazily from packed columns.

    The bulk ingest result (``TpuTree.last_operation`` after a columnar
    apply): consumers that only COUNT (the service's ``applied_count``)
    read :attr:`num_leaves`; consumers that need objects (the ≤4096-leaf
    response echo, JSON checkpoints) touch :attr:`ops` and pay the
    materialization exactly once.  Equality compares as a ``Batch`` of
    the same ops, across the class boundary.
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
    """A ``Batch`` over a log-position span of a reference-stable
    :class:`LogView`, materialized lazily — how ``restore_tiered``
    rebuilds ``last_operation`` from the manifest's ``last_op_span``
    without loading the cold segments the span lives in (a restore
    must stay O(tail); the span may be a whole bootstrap ingest).
    Consumers that only COUNT read :attr:`num_leaves`; touching
    :attr:`ops` pays the segment load exactly once."""

    def __init__(self, view: LogView, start: int, stop: int):
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
    """A row range of an in-memory PackedOps, as one hot segment."""

    __slots__ = ("packed", "start", "stop")

    def __init__(self, packed: PackedOps, start: int, stop: int):
        self.packed = packed
        self.start = start
        self.stop = stop

    def __len__(self) -> int:
        return self.stop - self.start


Segment = Union[List[Operation], _PackedSeg]


class TierConfig:
    """Cascade knobs (env defaults read by the serving layer):

    - ``hot_ops`` / ``hot_bytes`` — hot-tail budget; spill past it
      (``GRAFT_OPLOG_HOT_OPS`` / ``GRAFT_OPLOG_HOT_BYTES``).
    - ``gc_min_segs`` — minimum watermark-cleared cold segments before
      a base fold runs (``GRAFT_OPLOG_GC_SEGS``) — bounds base-rewrite
      write amplification.
    - ``auto_stable`` — single-node mode: everything applied is
      causally stable; the fleet layer disables this and feeds explicit
      watermarks instead.
    - ``cache_mb`` — byte budget of the LRU shared by spilled
      segments AND base chunks (``GRAFT_OPLOG_CACHE_MB``, default
      256) — one sizing knob for everything the cascade pages back
      in.  ``cache_segments`` (``GRAFT_OPLOG_CACHE_SEGS``) is the
      legacy entry-count mode, honored ONLY when ``cache_mb=0``.
    - ``base_chunk_ops`` — checkpoint-base chunk size
      (``GRAFT_OPLOG_BASE_CHUNK_OPS``): the base is a SEQUENCE of
      bounded packed-npz chunks, so a mid-history catch-up window
      opens only its covering chunks (and a fold rewrites at most the
      last partial chunk, never the whole base).
    - ``ephemeral`` — delete segment files on :meth:`OpLog.close`
      (serving docs spill into a scratch dir; checkpoints don't).
    - ``durable`` — crash-durable mode (docs/DURABILITY.md): segment
      and base files are fsynced at seal, and every layout change
      (spill, fold, tiered truncate) atomically rewrites
      ``manifest.json`` so a restart can always reopen the tiers —
      the WAL (wal.py) covers only the hot tail beyond them.
    """

    __slots__ = ("dir", "hot_ops", "hot_bytes", "gc_min_segs",
                 "auto_stable", "cache_segments", "cache_mb",
                 "base_chunk_ops", "ephemeral", "max_depth", "durable")

    def __init__(self, dir: str, hot_ops: int = 32768,
                 hot_bytes: int = 0, gc_min_segs: int = 4,
                 auto_stable: bool = True, cache_segments: int = 2,
                 ephemeral: bool = False,
                 max_depth: int = DEFAULT_MAX_DEPTH,
                 durable: bool = False,
                 cache_mb: Optional[int] = None,
                 base_chunk_ops: Optional[int] = None):
        self.dir = dir
        self.hot_ops = max(1, int(hot_ops))
        self.hot_bytes = int(hot_bytes)
        self.gc_min_segs = max(1, int(gc_min_segs))
        self.auto_stable = auto_stable
        self.cache_segments = max(1, int(cache_segments))
        if cache_mb is None:
            cache_mb = _env_int("GRAFT_OPLOG_CACHE_MB", 256)
        self.cache_mb = max(0, int(cache_mb))
        if base_chunk_ops is None:
            base_chunk_ops = _env_int("GRAFT_OPLOG_BASE_CHUNK_OPS",
                                      131072)
        self.base_chunk_ops = max(1, int(base_chunk_ops))
        self.ephemeral = ephemeral
        self.max_depth = max_depth
        self.durable = durable


class _SegCache:
    """Small LRU of loaded cold-segment/base-chunk columns, shared by a
    log's descriptors (and by every view pinning them).  Bounded so
    serving a cold window never accumulates the whole history back into
    memory; the load-latency histogram is the restore-path telemetry
    the prom surface exports (``crdt_oplog_segment_load_ms``).

    Sizing is BYTE-denominated (``GRAFT_OPLOG_CACHE_MB`` — ONE knob
    covers spilled segments and the chunked checkpoint base alike):
    with a byte budget set (the default), entries evict LRU-first
    once the resident estimate exceeds ``cap_bytes`` and the legacy
    entry cap is deliberately inert (a 2-entry cap would defeat
    multi-chunk window caching); only with ``cap_bytes=0``
    (``GRAFT_OPLOG_CACHE_MB=0``) does the ``cap`` entry count rule,
    preserving the pre-chunk sizing mode.  Evictions are counted
    (``crdt_oplog_cache_evictions``) so an operator can see a cache
    sized below the working set."""

    def __init__(self, cap: int, cap_bytes: int = 0):
        self.cap = cap
        self.cap_bytes = int(cap_bytes)
        self._mu = threading.Lock()
        self._od: "OrderedDict[str, PackedOps]" = OrderedDict()
        self._sizes: Dict[str, int] = {}
        self._bytes = 0
        self.loads = 0
        self.evictions = 0
        # per-DIRECTORY counters so logs SHARING this cache can report
        # their own loads/evictions instead of the engine-wide totals.
        # Keyed by dirname, not file path: every log's files live in
        # its own tier dir, so the dicts stay O(live logs) over the
        # engine's life instead of one entry per segment file ever
        # loaded (and the per-log series stay monotone across
        # spill/fold file churn — prometheus counters must never
        # regress)
        self._loads_by_dir: Dict[str, int] = {}
        self._evictions_by_dir: Dict[str, int] = {}
        self._hist = None

    def _histogram(self):
        if self._hist is None:
            # runtime-lazy: serve.metrics is import-safe by now (the
            # module cycle only matters at package import time)
            from .serve.metrics import LATENCY_BOUNDS_MS, Histogram
            self._hist = Histogram(LATENCY_BOUNDS_MS)
        return self._hist

    def get(self, path: str, loader: Callable[[], PackedOps]
            ) -> PackedOps:
        with self._mu:
            p = self._od.get(path)
            if p is not None:
                self._od.move_to_end(path)
                return p
        t0 = time.perf_counter()
        p = loader()
        ms = (time.perf_counter() - t0) * 1e3
        with self._mu:
            self.loads += 1
            d = os.path.dirname(path)
            self._loads_by_dir[d] = self._loads_by_dir.get(d, 0) + 1
            self._histogram().observe(ms)
            if path not in self._od:
                sz = _packed_resident(p)
                self._sizes[path] = sz
                self._bytes += sz
            self._od[path] = p
            self._od.move_to_end(path)
            # byte budget rules when set (one GRAFT_OPLOG_CACHE_MB
            # knob across segments and base chunks); the entry count
            # is the legacy backstop for byte-unbounded caches
            while len(self._od) > 1 and (
                    self._bytes > self.cap_bytes if self.cap_bytes
                    else len(self._od) > self.cap):
                victim, _ = self._od.popitem(last=False)
                self._bytes -= self._sizes.pop(victim, 0)
                self.evictions += 1
                vd = os.path.dirname(victim)
                self._evictions_by_dir[vd] = \
                    self._evictions_by_dir.get(vd, 0) + 1
        return p

    def note_load(self, ms: float) -> None:
        with self._mu:
            self.loads += 1
            self._histogram().observe(ms)

    def drop(self, path: str) -> None:
        with self._mu:
            if self._od.pop(path, None) is not None:
                self._bytes -= self._sizes.pop(path, 0)

    def clear(self) -> None:
        with self._mu:
            self._od.clear()
            self._sizes.clear()
            self._bytes = 0

    def resident_bytes(self) -> int:
        with self._mu:
            return self._bytes

    def resident_bytes_for(self, paths) -> int:
        """Resident bytes attributable to ``paths`` only — how a log
        sharing an ENGINE-wide cache reports its own footprint
        without claiming its neighbors' entries."""
        with self._mu:
            return sum(self._sizes.get(p, 0) for p in paths)

    def loads_for_dir(self, dir: str) -> int:
        """Cache-miss loads attributable to one log's tier dir (same
        shared-cache honesty rule as :meth:`resident_bytes_for`)."""
        with self._mu:
            return self._loads_by_dir.get(dir, 0)

    def evictions_for_dir(self, dir: str) -> int:
        with self._mu:
            return self._evictions_by_dir.get(dir, 0)

    def hist_export(self) -> Optional[dict]:
        with self._mu:
            return None if self._hist is None else self._hist.export()


def make_seg_cache(cache_mb: Optional[int] = None,
                   cap: int = 2) -> _SegCache:
    """A segment/chunk LRU an owner can SHARE across many logs —
    the serving engine builds one per engine so ``GRAFT_OPLOG_CACHE_MB``
    bounds the whole process's paged-in cold bytes, not 256 MB × docs
    (pass it via ``enable_tiering(cache=...)``)."""
    if cache_mb is None:
        cache_mb = _env_int("GRAFT_OPLOG_CACHE_MB", 256)
    return _SegCache(cap, cap_bytes=max(0, int(cache_mb)) << 20)


def _quarantine_manifest_extra(cs: "_ColdSeg") -> dict:
    """The manifest payload of a quarantined descriptor: the flag,
    plus — when the resident add index was built from the file's
    HEALTHY bytes (``index_ok``) — the index itself (base64 of the
    int64 ts / int32 pos columns), so a restart-inherited quarantine
    can still refuse a diverged peer's repair rows and keep resolving
    window marks in the covered range."""
    import base64
    out = {"quarantined": True}
    if cs.index_ok:
        out["add_index"] = {
            "ts": base64.b64encode(
                np.ascontiguousarray(cs.add_ts, np.int64)
                .tobytes()).decode("ascii"),
            "pos": base64.b64encode(
                np.ascontiguousarray(cs.add_pos, np.int32)
                .tobytes()).decode("ascii")}
    return out


def _decode_quarantine_index(entry: dict):
    """``(add_ts, add_pos)`` from a quarantined manifest entry, or
    ``None`` when absent/malformed — a garbled index degrades to the
    indexless placeholder (slower resync, never a failed open)."""
    import base64
    import binascii
    ai = entry.get("add_index")
    if not isinstance(ai, dict):
        return None
    try:
        ts = np.frombuffer(base64.b64decode(ai["ts"]), np.int64)
        pos = np.frombuffer(base64.b64decode(ai["pos"]), np.int32)
    except (KeyError, TypeError, ValueError, binascii.Error):
        return None
    if len(ts) != len(pos):
        return None
    return ts, pos


class _ColdSeg:
    """One on-disk tier member (a spilled segment, or the base).

    Resident state is only the descriptor plus a sorted add-timestamp
    index (``add_ts`` ascending, ``add_pos`` the matching row positions
    relative to the segment): enough to resolve ``operations_since``
    terminators, window resume points, and the stability watermark
    without touching disk.  Column loads go through the shared
    :class:`_SegCache`."""

    __slots__ = ("path", "start", "length", "add_ts", "add_pos",
                 "file_bytes", "cache", "hints_vouched",
                 "quarantined", "index_ok", "wire")

    def __init__(self, path: str, start: int, length: int,
                 add_ts: np.ndarray, add_pos: np.ndarray,
                 file_bytes: int, cache: Optional[_SegCache],
                 hints_vouched: bool = False):
        self.path = path
        self.start = start
        self.length = length
        self.add_ts = add_ts
        self.add_pos = add_pos
        self.file_bytes = file_bytes
        self.cache = cache
        self.hints_vouched = hints_vouched
        # scrub quarantine (docs/DURABILITY.md §Scrub & repair): a
        # descriptor whose file failed its checksum scrub refuses to
        # load — typed error, never corrupt bytes — until peer repair
        # swaps a re-fetched, re-sealed file in.  ``index_ok`` is
        # False only for placeholders reopened from a quarantined
        # manifest entry (their resident add index was never built
        # from healthy bytes, so a repair can't be cross-checked
        # against it).
        self.quarantined = False
        self.index_ok = True
        # wire sidecar state (zero-copy egress): None =
        # unprobed, "building" = a build/load is queued or running,
        # a WireIndex = ready to serve by sendfile, False = this
        # segment can never serve zero-copy (non-JSON-native payload,
        # failed verify) — the buffered path owns it forever
        self.wire: Any = None

    @staticmethod
    def placeholder(path: str, start: int, length: int,
                    cache: Optional[_SegCache],
                    add_ts: Optional[np.ndarray] = None,
                    add_pos: Optional[np.ndarray] = None) -> "_ColdSeg":
        """A quarantined manifest entry reopened after a restart: the
        slot keeps the tier layout contiguous and every load is a
        typed refusal.  When the manifest persisted the segment's
        PRE-CORRUPTION add index (quarantine writes it alongside the
        flag), the restart inherits it — ``index_ok`` stays True, so
        peer repair keeps its divergence cross-check and window marks
        in the covered range still resolve.  Without it the empty add
        index simply fails to resolve marks in the covered range
        (``found=0`` → the puller re-pulls from an earlier mark —
        correct, just slower) and a repair cannot be cross-checked."""
        inherited = add_ts is not None and add_pos is not None
        seg = _ColdSeg(path, start, length,
                       add_ts if inherited else np.zeros(0, np.int64),
                       add_pos if inherited else np.zeros(0, np.int32),
                       0, cache, False)
        seg.quarantined = True
        seg.index_ok = inherited
        return seg

    @staticmethod
    def _add_index(kind: np.ndarray, ts: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        rel = np.nonzero(np.asarray(kind) == KIND_ADD)[0]
        tsv = np.asarray(ts)[rel]
        order = np.argsort(tsv, kind="stable")
        # positions are segment-relative → int32 halves the resident
        # index (12 bytes/add total — the cascade's O(adds) metadata)
        return (tsv[order].astype(np.int64),
                rel[order].astype(np.int32))

    @staticmethod
    def seal(p: PackedOps, start: int, path: str,
             cache: Optional[_SegCache],
             compress: bool = False,
             fsync: bool = False) -> "_ColdSeg":
        """Write ``p``'s rows as one segment file and return its
        descriptor (add index built from the columns in hand — no
        read-back).  ``fsync``: durable mode — the file must be on
        disk BEFORE the manifest references it (and before the WAL
        prefix it replaces is truncated)."""
        from . import engine as engine_mod
        n = p.num_ops
        meta = {"num_ops": n, "hints_vouched": bool(p.hints_vouched),
                "start": start, "kind": "oplog-segment"}
        engine_mod.write_packed_npz(path, p, meta, compress=compress)
        if fsync:
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        add_ts, add_pos = _ColdSeg._add_index(p.kind[:n], p.ts[:n])
        return _ColdSeg(path, start, n, add_ts, add_pos,
                        os.path.getsize(path), cache,
                        bool(p.hints_vouched))

    @staticmethod
    def open(path: str, start: int, length: int,
             cache: Optional[_SegCache]) -> "_ColdSeg":
        """Descriptor from an existing segment file: reads only the
        ``kind``/``ts`` columns (the add index) — the checkpoint+tail
        bootstrap never pulls full cold columns into memory.  Raises
        :class:`CheckpointError` on any missing/corrupt/mismatched
        file."""
        cols, meta = packed_mod.load_packed_npz(path, light=True)
        if meta["num_ops"] != length:
            raise CheckpointError(
                f"op-log segment {path!r} holds {meta['num_ops']} ops; "
                f"manifest says {length}")
        add_ts, add_pos = _ColdSeg._add_index(cols["kind"], cols["ts"])
        try:
            fb = os.path.getsize(path)
        except OSError:
            fb = 0
        return _ColdSeg(path, start, length, add_ts, add_pos, fb,
                        cache, bool(meta.get("hints_vouched", False)))

    def load(self, use_cache: bool = True) -> PackedOps:
        """The segment's full columns (LRU-cached).  Raises
        :class:`CheckpointError` when the file is missing or corrupt —
        a collected-but-still-needed segment must fail loudly, never
        serve a silent partial log — and when the segment is
        QUARANTINED (scrub found bit-rot; peer repair pending): the
        corrupt bytes are never served, not even by a read that races
        the repair."""
        if self.quarantined:
            raise CheckpointError(
                f"op-log segment {self.path!r} is quarantined "
                f"(checksum scrub failed; repair pending)")
        def _loader() -> PackedOps:
            p, _ = packed_mod.load_packed_npz(self.path)
            if p.num_ops != self.length:
                raise CheckpointError(
                    f"op-log segment {self.path!r} holds {p.num_ops} "
                    f"ops; descriptor says {self.length}")
            return p
        if use_cache and self.cache is not None:
            return self.cache.get(self.path, _loader)
        t0 = time.perf_counter()
        p = _loader()
        if self.cache is not None:
            self.cache.note_load((time.perf_counter() - t0) * 1e3)
        return p

    def index_of(self, ts: int) -> Optional[int]:
        """Row position (relative to the segment) of the Add with
        timestamp ``ts``, from the resident index — no disk touch."""
        i = int(np.searchsorted(self.add_ts, ts))
        if i < self.add_ts.size and int(self.add_ts[i]) == ts:
            return int(self.add_pos[i])
        return None

    @property
    def n_adds(self) -> int:
        return int(self.add_ts.size)

    def index_bytes(self) -> int:
        return int(self.add_ts.nbytes + self.add_pos.nbytes)

    def __len__(self) -> int:
        return self.length


# -- zero-copy wire sidecars (docs/SERVING.md §Zero-copy
# egress) --------------------------------------------------------------
#
# The /ops wire body is a pure concatenation:
#
#     b'{"op":"batch","ops":[' + b",".join(per-op JSON) + b']}'
#
# and a sealed segment is immutable — so its comma-joined per-op JSON
# can be precomputed ONCE into a flat sidecar file (``<seg>.wire``)
# with a row-offset index (``<seg>.wirex``).  A catch-up window that
# lands entirely on cold tiers then ships as a handful of
# ``os.sendfile`` ranges instead of load → unpack → re-encode per
# pull.  The concatenation property is not assumed: the build VERIFIES
# the assembled bytes against ``engine.packed_since_bytes`` over the
# segment's own rows and permanently refuses zero-copy for the segment
# on any mismatch (the buffered path owns it), and a sidecar reopened
# from disk must pass a length + sha1 check before it serves.

WIRE_PREFIX = b'{"op":"batch","ops":['
WIRE_SUFFIX = b']}'


def wire_paths(seg_path: str) -> Tuple[str, str]:
    """(payload path, index path) of a segment's wire sidecar."""
    return seg_path + ".wire", seg_path + ".wirex"


class WireIndex:
    """Resident index over one ``.wire`` sidecar: byte offset + length
    of every row's JSON encoding (interior commas live between rows, so
    rows [lo, hi) are ONE contiguous byte range)."""

    __slots__ = ("path", "row_start", "row_len", "payload_len")

    def __init__(self, path: str, row_start: np.ndarray,
                 row_len: np.ndarray):
        self.path = path
        self.row_start = row_start
        self.row_len = row_len
        self.payload_len = (int(row_start[-1] + row_len[-1])
                            if len(row_len) else 0)

    def range_of(self, lo: int, hi: int) -> Tuple[int, int]:
        """(offset, length) of rows [lo, hi) in the payload file —
        includes the commas BETWEEN those rows, excludes any comma
        before ``lo`` or after ``hi - 1``."""
        off = int(self.row_start[lo])
        end = int(self.row_start[hi - 1] + self.row_len[hi - 1])
        return off, end - off


def build_wire_sidecar(seg: "_ColdSeg") -> bool:
    """Encode ``seg``'s rows into its wire sidecar (tmp + rename; the
    index file lands LAST, so its presence is the ready flag).  Marks
    ``seg.wire`` with the resident :class:`WireIndex` on success,
    ``False`` permanently when the assembled bytes fail verification
    against the buffered encoder, and back to ``None`` (retryable —
    e.g. after peer repair) when the segment itself can't load."""
    from . import engine as engine_mod
    from .codec import json_codec
    try:
        p = seg.load()
    except CheckpointError:
        seg.wire = None
        return False
    n = p.num_ops
    encs = [json_codec.dumps(op).encode()
            for op in packed_mod.unpack_rows(p, 0, n)]
    payload = b",".join(encs)
    if WIRE_PREFIX + payload + WIRE_SUFFIX \
            != engine_mod.packed_since_bytes(p, 0):
        seg.wire = False
        return False
    row_len = np.asarray([len(e) for e in encs], dtype=np.int64)
    row_start = np.zeros(n, np.int64)
    if n > 1:
        row_start[1:] = np.cumsum(row_len[:-1] + 1)
    wp, xp = wire_paths(seg.path)
    try:
        tmp = wp + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, wp)
        xtmp = xp + ".tmp"
        digest = np.frombuffer(hashlib.sha1(payload).digest(),
                               dtype=np.uint8).copy()
        with open(xtmp, "wb") as f:
            np.savez(f, row_start=row_start, row_len=row_len,
                     digest=digest)
        os.replace(xtmp, xp)
    except OSError:
        seg.wire = None
        return False
    seg.wire = WireIndex(wp, row_start, row_len)
    return True


def load_wire_index(seg: "_ColdSeg") -> bool:
    """Reopen an existing sidecar pair (durable dirs persist them
    across restarts).  The payload must match the index's row count,
    total length, AND sha1 — a sidecar is serve-ready or it is
    nothing; a stale/torn/bit-rotted one simply fails to load and the
    caller rebuilds."""
    wp, xp = wire_paths(seg.path)
    try:
        with np.load(xp) as z:
            row_start = z["row_start"].astype(np.int64)
            row_len = z["row_len"].astype(np.int64)
            digest = z["digest"].tobytes()
        if len(row_start) != seg.length or len(row_len) != seg.length:
            return False
        expect = (int(row_start[-1] + row_len[-1])
                  if seg.length else 0)
        if os.path.getsize(wp) != expect:
            return False
        h = hashlib.sha1()
        with open(wp, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if h.digest() != digest:
            return False
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return False
    seg.wire = WireIndex(wp, row_start, row_len)
    return True


def ensure_wire_sidecar(seg: "_ColdSeg") -> bool:
    """Idempotent load-or-build (the maintenance worker's ``wire``
    task).  Returns readiness."""
    if isinstance(seg.wire, WireIndex):
        return True
    if seg.wire is False:
        return False
    if seg.quarantined:
        seg.wire = None
        return False
    if load_wire_index(seg):
        return True
    return build_wire_sidecar(seg)


def drop_wire_sidecars(seg_path: str) -> None:
    """Delete a segment's sidecar pair, if present — called wherever
    the segment FILE is deleted (ephemeral close, watermark GC, repair
    swap), so sidecars can never outlive or mismatch their segment."""
    for p in wire_paths(seg_path):
        try:
            os.remove(p)
        except OSError:
            pass


# module-wide plan-etag LRU: the window etag contract is "quoted sha1
# of the wire bytes" (serve/snapshot.py), and the plan path must emit
# the IDENTICAL validator without materializing the body per request.
# Segment files are immutable and content-addressed by path, so the
# hash is cached keyed by the plan's exact chunk identity — one
# streaming read per distinct window, shared across snapshots and docs.
_ETAG_LRU_CAP = 256
_etag_mu = threading.Lock()
_etag_lru: "OrderedDict[tuple, str]" = OrderedDict()


def plan_etag(chunks: List[tuple]) -> Optional[str]:
    """Quoted sha1 of a plan's assembled wire bytes (None when a
    sidecar file vanished under us — caller falls back to buffered)."""
    key = tuple(c[1:] if c[0] == "f" else c[1] for c in chunks)
    with _etag_mu:
        hit = _etag_lru.get(key)
        if hit is not None:
            _etag_lru.move_to_end(key)
            return hit
    h = hashlib.sha1()
    try:
        for c in chunks:
            if c[0] == "b":
                h.update(c[1])
            else:
                _, path, off, ln = c
                with open(path, "rb") as f:
                    f.seek(off)
                    remaining = ln
                    while remaining:
                        b = f.read(min(1 << 20, remaining))
                        if not b:
                            raise OSError(f"short read in {path!r}")
                        h.update(b)
                        remaining -= len(b)
    except OSError:
        return None
    etag = f'"{h.hexdigest()}"'
    with _etag_mu:
        _etag_lru[key] = etag
        while len(_etag_lru) > _ETAG_LRU_CAP:
            _etag_lru.popitem(last=False)
    return etag


# one view part: (tag, payload, lo, hi, gstart) — tag "obj" (list of
# ops), "packed" (in-memory PackedOps rows), or "cold" (_ColdSeg rows);
# lo/hi index INTO the payload, gstart is the part's global log position
_ViewPart = Tuple[str, Any, int, int, int]


class LogView:
    """An immutable, reference-stable snapshot of the cascade's
    physical layout (see module docstring).  Everything a read surface
    needs resolves against this: ``operations_since`` suffixes, bounded
    anti-entropy windows (byte-identical to the untiered
    ``engine.packed_since_window``), full-column reassembly for
    ``/snapshot`` bootstraps.  The log only ever REPLACES descriptors,
    so a view taken before a spill/compaction/GC keeps serving the
    exact same rows."""

    __slots__ = ("parts", "length", "last_add_pos", "max_depth",
                 "_starts", "_packed_all", "__weakref__")

    def __init__(self, parts: Tuple[_ViewPart, ...], length: int,
                 last_add_pos: Optional[int],
                 max_depth: int = DEFAULT_MAX_DEPTH):
        self.parts = parts
        self.length = length
        self.last_add_pos = last_add_pos
        self.max_depth = max_depth
        self._starts = np.asarray([p[4] for p in parts],
                                  dtype=np.int64)
        self._packed_all: Optional[PackedOps] = None

    # -- part helpers -----------------------------------------------------

    @property
    def num_segments(self) -> int:
        return len(self.parts)

    def references(self, payload: Any) -> bool:
        """Identity check the GC uses before deleting a segment file:
        a live view pinning a descriptor defers its deletion."""
        return any(part[1] is payload for part in self.parts)

    def _first_part(self, pos: int) -> int:
        if not len(self._starts):
            return 0
        return max(0, int(np.searchsorted(self._starts, pos,
                                          side="right")) - 1)

    @staticmethod
    def _part_ops(tag: str, payload, lo: int, hi: int
                  ) -> List[Operation]:
        if tag == "obj":
            return list(payload[lo:hi])
        p = payload if tag == "packed" else payload.load()
        return packed_mod.unpack_rows(p, lo, hi)

    def _part_packed(self, tag: str, payload, lo: int, hi: int
                     ) -> PackedOps:
        if tag == "obj":
            return packed_mod.pack(list(payload[lo:hi]),
                                   max_depth=self.max_depth)
        p = payload if tag == "packed" else payload.load()
        if lo == 0 and hi == p.num_ops:
            return p
        return packed_mod.select_rows(p, np.arange(lo, hi))

    def _overlaps(self, start: int, stop: int):
        """Yield ``(tag, payload, plo, phi)`` for the parts overlapping
        global rows [start, stop), with lo/hi clipped to the overlap."""
        for k in range(self._first_part(start), len(self.parts)):
            tag, payload, lo, hi, g = self.parts[k]
            ln = hi - lo
            if g >= stop:
                break
            s = max(start - g, 0)
            e = min(stop - g, ln)
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
        ``operations_since`` terminator) or None.  Cold tiers answer
        from the resident add index — no disk touch."""
        for tag, payload, lo, hi, g in self.parts:
            if tag == "obj":
                for j in range(lo, hi):
                    op = payload[j]
                    if isinstance(op, Add) and op.ts == ts:
                        return g + (j - lo)
            elif tag == "packed":
                hit = payload.index().get(ts)
                if hit is not None and lo <= hit < hi:
                    return g + (hit - lo)
            else:
                rel = payload.index_of(ts)
                if rel is not None and lo <= rel < hi:
                    return g + (rel - lo)
        return None

    def kinds(self, start: int, stop: int) -> np.ndarray:
        """op kinds for global rows [start, stop) — loads only the
        touched cold segments (which a window serving those rows loads
        anyway)."""
        chunks: List[np.ndarray] = []
        for tag, payload, lo, hi in self._overlaps(start, stop):
            if tag == "obj":
                chunks.append(np.fromiter(
                    (KIND_ADD if isinstance(payload[j], Add)
                     else packed_mod.KIND_DELETE
                     for j in range(lo, hi)),
                    dtype=np.int8, count=hi - lo))
            else:
                p = payload if tag == "packed" else payload.load()
                chunks.append(np.asarray(p.kind[lo:hi], dtype=np.int8))
        if not chunks:
            return np.zeros(0, np.int8)
        return np.concatenate(chunks)

    def next_add_at_or_after(self, pos: int) -> Optional[int]:
        """Global position of the first Add at or after ``pos`` — cold
        tiers answer from the resident index."""
        for k in range(self._first_part(pos), len(self.parts)):
            tag, payload, lo, hi, g = self.parts[k]
            rel_from = lo + max(0, pos - g)
            if rel_from >= hi:
                continue
            if tag == "obj":
                for j in range(rel_from, hi):
                    if isinstance(payload[j], Add):
                        return g + (j - lo)
            elif tag == "packed":
                idx = np.nonzero(
                    payload.kind[rel_from:hi] == KIND_ADD)[0]
                if len(idx):
                    return g + (rel_from + int(idx[0]) - lo)
            else:
                cand = payload.add_pos[(payload.add_pos >= rel_from)
                                       & (payload.add_pos < hi)]
                if cand.size:
                    return g + (int(cand.min()) - lo)
        return None

    # -- column reassembly ------------------------------------------------

    def slice_packed(self, start: int, stop: int) -> PackedOps:
        """Rows [start, stop) as one self-contained PackedOps — the
        window body's column source.  Row content is identical to
        slicing the untiered full packing (values subset per part and
        renumbered by ``concat_many`` exactly as ``select_rows``
        would), which is what makes tiered window bytes equal the
        untiered ones."""
        start = max(start, 0)
        stop = min(stop, self.length)
        pieces = [self._part_packed(tag, payload, lo, hi)
                  for tag, payload, lo, hi in self._overlaps(start, stop)]
        if not pieces:
            return packed_mod.pack([], max_depth=self.max_depth)
        return packed_mod.concat_many(pieces)

    def to_packed(self) -> PackedOps:
        """The whole view as one PackedOps (cached on the view: a
        snapshot's ``/snapshot`` + ``/ops?since=0`` consumers share one
        reassembly per published generation)."""
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
        """Wire JSON for ``GET /ops?since=`` — byte-identical to
        ``engine.packed_since_bytes`` over the untiered full packing."""
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
        the untiered full packing (the trimming rules below mirror it
        clause for clause, across every tier seam):

        - windows end on their last Add (the resume terminator; the
          trailing deletes re-serve next window);
        - an all-delete window extends through the next Add;
        - an all-delete log TAIL ships with its window (there is no
          later Add to carry it — the PR-6 chain-looping fix).
        """
        from . import engine as engine_mod
        p = self._single_full_packed()
        if p is not None:
            return engine_mod.packed_since_window(p, since, limit)
        start, stop, early = self._window_bounds(since, limit)
        if early is not None:
            return EMPTY_BATCH_BYTES, early
        n = self.length
        sub = self.slice_packed(start, stop)
        body = engine_mod.packed_since_bytes(sub, 0)
        served = np.nonzero(sub.kind[:sub.num_ops] == KIND_ADD)[0]
        next_since = int(sub.ts[int(served[-1])]) if len(served) \
            else None
        return body, {"found": True, "more": stop < n,
                      "next_since": next_since, "count": stop - start}

    def _window_bounds(self, since: int, limit: int):
        """The window's row bounds — the SINGLE trimming implementation
        behind both :meth:`window` (buffered) and :meth:`window_plan`
        (zero-copy), so the two paths can never disagree on what a
        window contains.  Returns ``(start, stop, None)`` for a
        non-empty window or ``(0, 0, meta)`` when the answer is the
        empty batch (unresolved mark / caught-up log), with ``meta``
        exactly what :meth:`window` serves for that case."""
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
            kinds = self.kinds(start, start + limit)
            window_adds = np.nonzero(kinds == KIND_ADD)[0]
            # mirror of engine.packed_since_window clause for clause —
            # including the no-progress guard: a resumed window whose
            # only Add is the inclusive terminator extends through the
            # next Add instead of re-serving itself forever
            if len(window_adds) and (since == 0
                                     or int(window_adds[-1]) > 0):
                stop = start + int(window_adds[-1]) + 1
            else:
                nxt = self.next_add_at_or_after(start + limit)
                stop = nxt + 1 if nxt is not None else n
            if stop < n and (self.last_add_pos is None
                             or self.last_add_pos < stop):
                # everything past the trimmed window is deletes:
                # serve the tail NOW (PR-6 all-delete-tail rule)
                stop = n
        return start, stop, None

    def window_plan(self, since: int, limit: int):
        """Zero-copy serving plan for the same window :meth:`window`
        would serve — ``(plan, missing)``.

        ``plan`` is ``(chunks, total_len, meta)`` when the window lands
        ENTIRELY on non-quarantined cold parts whose wire sidecars are
        ready: ``chunks`` is an ordered list of ``("b", bytes)`` literal
        pieces (batch envelope, inter-segment commas) and
        ``("f", path, offset, length)`` sidecar file ranges the handler
        ships with ``os.sendfile``; the assembled bytes are
        byte-identical to :meth:`window`'s body and ``meta`` matches its
        meta field for field (``next_since`` resolves from the resident
        add indexes — no column load).  ``plan`` is None whenever any
        part is hot, quarantined, or sidecar-less — the buffered path
        serves those — and ``missing`` then lists the cold segments
        whose sidecars exist to be built (the caller queues builds; the
        NEXT pull of this window goes zero-copy).

        Bounds resolution may still pull cold columns through the
        segment LRU (the trimming scan): what the plan path eliminates
        is the per-pull unpack → JSON-encode → concat of the body,
        which dominates catch-up egress cost."""
        missing: List[_ColdSeg] = []
        if limit <= 0 or self._single_full_packed() is not None:
            return None, missing
        start, stop, early = self._window_bounds(since, limit)
        if early is not None:
            return None, missing
        parts: List[Tuple[_ColdSeg, int, int]] = []
        for tag, payload, lo, hi in self._overlaps(start, stop):
            if tag != "cold" or payload.quarantined:
                return None, missing
            parts.append((payload, lo, hi))
        if not parts:
            return None, missing
        ready = True
        for seg, _, _ in parts:
            if isinstance(seg.wire, WireIndex):
                continue
            ready = False
            if seg.wire is None:
                missing.append(seg)
        if not ready:
            return None, missing
        chunks: List[tuple] = [("b", WIRE_PREFIX)]
        total = len(WIRE_PREFIX)
        for k, (seg, lo, hi) in enumerate(parts):
            if k:
                chunks.append(("b", b","))
                total += 1
            off, ln = seg.wire.range_of(lo, hi)
            chunks.append(("f", seg.wire.path, off, ln))
            total += ln
        chunks.append(("b", WIRE_SUFFIX))
        total += len(WIRE_SUFFIX)
        next_since = None
        for seg, lo, hi in reversed(parts):
            mask = (seg.add_pos >= lo) & (seg.add_pos < hi)
            if mask.any():
                pos = seg.add_pos[mask]
                next_since = int(seg.add_ts[mask][int(np.argmax(pos))])
                break
        meta = {"found": True, "more": stop < self.length,
                "next_since": next_since, "count": stop - start}
        return (chunks, total, meta), missing


class OpLog:
    """Chronological applied-op log over the three-tier cascade (see
    module docstring).  Untiered by default — construction, writers,
    readers, truncate, and checkpoints behave exactly like the plain
    columnar log until :meth:`enable_tiering` is called (the serving
    engine enables it per document; bare library trees stay untiered).

    Thread model: a reentrant lock guards the tier structure, because
    the fleet's anti-entropy thread runs watermark GC concurrently with
    the scheduler thread's appends.  Published :class:`LogView` objects
    are immutable and read lock-free."""

    def __init__(self, ops: Iterable[Operation] = ()):
        self._mu = threading.RLock()
        self._segs: List[Segment] = []      # hot tail
        self._cold: List[_ColdSeg] = []
        # checkpoint base as a SEQUENCE of bounded chunks (ascending
        # .start): a mid-history window opens only covering chunks,
        # and a fold rewrites at most the last partial chunk
        self._bases: List[_ColdSeg] = []
        # persisted-materialization entry carried by the manifest
        # ({"file", "len"}; engine.TpuTree writes the artifact and
        # calls note_matz) — dropped whenever a truncate cuts below
        # its coverage, so a restore can never replay on top of a
        # state containing rolled-back ops
        self._matz: Optional[dict] = None
        self._matz_tombs: List[str] = []
        self._matz_seq = 0
        self._len = 0
        self._hot_len = 0
        self._tiered_len = 0
        self._last_add: Optional[int] = None
        self._cfg: Optional[TierConfig] = None
        self._cache: Optional[_SegCache] = None
        self._cache_shared = False
        self._stable: Optional[int] = None
        self._on_spill: Optional[Callable[[], None]] = None
        # deferred spill policy (serve/workers.py MaintenanceWorker):
        # when set, a due spill is HANDED to the worker instead of
        # sealing segments on the calling (scheduler) thread; past the
        # hard cap the spill runs inline anyway so resident memory
        # stays bounded even when the worker lags (inline_cb counts
        # those fallbacks)
        self._defer_cb: Optional[Callable[[], None]] = None
        self._inline_cb: Optional[Callable[[], None]] = None
        self._hard_cap_ops = 0
        self._hard_cap_bytes = 0
        # age-based spill policy (GRAFT_OPLOG_HOT_AGE_S): monotonic
        # time the oldest unspilled hot op has been resident —
        # approximate (reset on spill: the spilled prefix IS the
        # oldest), enough for a many-doc idle-tail sweep
        self._hot_since: Optional[float] = None
        # durable mode (docs/DURABILITY.md): meta_cb supplies the
        # manifest's clock/cursor meta at write time; on_advance is
        # told the new tiered extent after every manifest write so
        # the owner can truncate the WAL prefix the tiers now cover
        self._meta_cb: Optional[Callable[[], dict]] = None
        self._on_advance: Optional[Callable[[int], None]] = None
        self._views: "weakref.WeakSet[LogView]" = weakref.WeakSet()
        self._tombs: List[_ColdSeg] = []
        self._advance_pending: Optional[int] = None
        self._file_seq = 0
        self._base_gen = 0
        # telemetry counters (crdt_oplog_* prom families)
        self.spills = 0
        self.compactions = 0
        self.segments_gc = 0
        self.gc_deferred = 0
        # scrub-with-peer-repair counters (crdt_scrub_* families)
        self.quarantines = 0
        self.repairs = 0
        ops = list(ops)
        if ops:
            self.extend(ops)

    # -- tiering lifecycle -------------------------------------------------

    def enable_tiering(self, dir: str, *, hot_ops: int = 32768,
                       hot_bytes: int = 0, gc_min_segs: int = 4,
                       auto_stable: bool = True,
                       cache_segments: int = 2,
                       ephemeral: bool = False,
                       max_depth: int = DEFAULT_MAX_DEPTH,
                       on_spill: Optional[Callable[[], None]] = None,
                       durable: bool = False,
                       cache_mb: Optional[int] = None,
                       base_chunk_ops: Optional[int] = None,
                       cache: Optional[_SegCache] = None
                       ) -> "OpLog":
        """Arm the cascade: ops past the hot budget spill to packed-npz
        files under ``dir`` at the next :meth:`maybe_spill`.
        ``on_spill`` lets the owning tree drop its full-packing cache
        when resident columns move to disk.  ``durable`` arms
        crash-durable manifests (TierConfig docstring); wire the
        manifest meta + WAL-truncate callbacks via
        :meth:`set_durable_hooks`.  ``cache``: a caller-owned
        (possibly engine-SHARED) segment LRU (:func:`make_seg_cache`)
        — the byte budget then bounds every sharing log together."""
        with self._mu:
            os.makedirs(dir, exist_ok=True)
            self._cfg = TierConfig(dir, hot_ops=hot_ops,
                                   hot_bytes=hot_bytes,
                                   gc_min_segs=gc_min_segs,
                                   auto_stable=auto_stable,
                                   cache_segments=cache_segments,
                                   ephemeral=ephemeral,
                                   max_depth=max_depth,
                                   durable=durable,
                                   cache_mb=cache_mb,
                                   base_chunk_ops=base_chunk_ops)
            if cache is not None:
                self._cache = cache
                self._cache_shared = True
            if self._cache is None:
                self._cache = _SegCache(
                    self._cfg.cache_segments,
                    cap_bytes=self._cfg.cache_mb << 20)
            if on_spill is not None:
                self._on_spill = on_spill
            if auto_stable:
                self._stable = self._len
        return self

    @property
    def tiering_enabled(self) -> bool:
        return self._cfg is not None

    def set_auto_stable(self, flag: bool) -> None:
        """Fleet mode turns auto-stability OFF: the watermark then only
        moves when :meth:`set_stable_mark` is fed from the anti-entropy
        mark exchange (cluster/gateway.py)."""
        with self._mu:
            if self._cfg is not None:
                self._cfg.auto_stable = flag
                if not flag:
                    self._stable = 0

    def set_stable_mark(self, pos: int) -> None:
        """Causal-stability watermark: every fleet replica has pulled
        the log through position ``pos``.  Gates checkpoint advancement
        and segment GC — rows at or above it are never folded or
        collected, so no replica can be stranded needing them."""
        with self._mu:
            self._stable = max(0, min(int(pos), self._len))

    @property
    def stable_mark(self) -> int:
        with self._mu:
            return self._stable_locked()

    @property
    def tiered_extent(self) -> int:
        """Ops durable in cold segments + base (what the manifest
        covers; the WAL-truncation watermark)."""
        with self._mu:
            return self._tiered_len

    def _stable_locked(self) -> int:
        if self._cfg is not None and self._cfg.auto_stable:
            return self._len
        return self._stable if self._stable is not None else 0

    def close(self) -> None:
        """Release the cascade's disk footprint (ephemeral logs delete
        their segment files — the serving scratch tier)."""
        with self._mu:
            cfg = self._cfg
            if cfg is not None and cfg.ephemeral:
                segs = self._bases + self._cold + self._tombs
                for seg in segs:
                    try:
                        os.remove(seg.path)
                    except OSError:
                        pass
                    drop_wire_sidecars(seg.path)
                matz_files = list(self._matz_tombs)
                if self._matz is not None:
                    matz_files.append(os.path.join(
                        cfg.dir, self._matz["file"]))
                for fp in matz_files:
                    try:
                        os.remove(fp)
                    except OSError:
                        pass
                try:
                    os.rmdir(cfg.dir)
                except OSError:
                    pass
            if self._cache is not None:
                if self._cache_shared:
                    # an engine-shared cache outlives this log: drop
                    # only OUR entries, never the neighbors'
                    for seg in self._bases + self._cold + self._tombs:
                        self._cache.drop(seg.path)
                else:
                    self._cache.clear()

    # -- writers ----------------------------------------------------------

    def append(self, op: Operation) -> None:
        with self._mu:
            if self._segs and isinstance(self._segs[-1], list):
                self._segs[-1].append(op)
            else:
                self._segs.append([op])
            if isinstance(op, Add):
                self._last_add = self._len
            if self._hot_len == 0:
                self._hot_since = time.monotonic()
            self._len += 1
            self._hot_len += 1

    def extend(self, ops: Iterable[Operation]) -> None:
        ops = list(ops)
        if not ops:
            return
        with self._mu:
            if self._segs and isinstance(self._segs[-1], list):
                self._segs[-1].extend(ops)
            else:
                self._segs.append(ops)
            for j in range(len(ops) - 1, -1, -1):
                if isinstance(ops[j], Add):
                    self._last_add = self._len + j
                    break
            if self._hot_len == 0:
                self._hot_since = time.monotonic()
            self._len += len(ops)
            self._hot_len += len(ops)

    def extend_packed(self, p: PackedOps, start: int = 0,
                      stop: Optional[int] = None) -> None:
        """Append rows ``[start, stop)`` of ``p`` as one column segment —
        O(1) plus an O(delta) kind scan for the last-Add cursor; no
        objects are built."""
        stop = p.num_ops if stop is None else stop
        if stop <= start:
            return
        with self._mu:
            self._segs.append(_PackedSeg(p, start, stop))
            adds = np.nonzero(p.kind[start:stop] == KIND_ADD)[0]
            if len(adds):
                self._last_add = self._len + int(adds[-1])
            if self._hot_len == 0:
                self._hot_since = time.monotonic()
            self._len += stop - start
            self._hot_len += stop - start

    def truncate(self, n: int) -> None:
        """Drop everything at index ``n`` and after (batch rollback).
        Copy-on-truncate: affected segments are REPLACED, never mutated
        in place, so published views keep their frozen extents.  A cut
        below the cold/base extent reloads the straddling segment into
        the hot tier (rare — rollbacks target ops appended since the
        last commit, and the engine defers spills across multi-chunk
        applies precisely so the rolled-back range stays hot)."""
        with self._mu:
            if n >= self._len:
                return
            n = max(0, n)
            # a persisted materialization covering rolled-back ops
            # must never survive the rollback: a restore replaying a
            # tail on top of it would resurrect the cut ops
            matz_cut = self._matz is not None \
                and n < int(self._matz.get("len", 0))
            if matz_cut:
                self._drop_matz_locked()
            if n >= self._tiered_len:
                self._truncate_hot_locked(n - self._tiered_len)
                if matz_cut:
                    self._durable_manifest_locked()
            else:
                self._truncate_tiered_locked(n)
                # durable mode: the tier layout changed — the manifest
                # must stop referencing the cut segments before a
                # restart could reopen them
                self._durable_manifest_locked()
            self._len = n
            if self._last_add is not None and self._last_add >= n:
                self._recompute_last_add_locked()
            if self._stable is not None:
                self._stable = min(self._stable, n)
        self._fire_advance()

    def _truncate_hot_locked(self, keep_hot: int) -> None:
        base = 0
        for k, seg in enumerate(self._segs):
            ln = len(seg)
            if base + ln > keep_hot:
                keep = keep_hot - base
                if keep == 0:
                    del self._segs[k:]
                elif isinstance(seg, list):
                    self._segs[k] = seg[:keep]
                    del self._segs[k + 1:]
                else:
                    self._segs[k] = _PackedSeg(seg.packed, seg.start,
                                               seg.start + keep)
                    del self._segs[k + 1:]
                self._hot_len = keep_hot
                return
            base += ln
        self._hot_len = keep_hot

    def _truncate_tiered_locked(self, n: int) -> None:
        bases = set(map(id, self._bases))
        tiers = self._bases + self._cold
        new_bases: List[_ColdSeg] = []
        new_cold: List[_ColdSeg] = []
        hot_seg: Optional[_PackedSeg] = None
        for seg in tiers:
            if seg.start + seg.length <= n:
                if id(seg) in bases:
                    new_bases.append(seg)
                else:
                    new_cold.append(seg)
            elif seg.start < n:
                p = seg.load(use_cache=False)
                hot_seg = _PackedSeg(p, 0, n - seg.start)
                self._tombs.append(seg)
            else:
                self._tombs.append(seg)
        self._bases = new_bases
        self._cold = new_cold
        self._tiered_len = sum(cs.length for cs in new_bases) \
            + sum(cs.length for cs in new_cold)
        self._segs = [hot_seg] if hot_seg is not None else []
        self._hot_len = len(hot_seg) if hot_seg is not None else 0

    def _recompute_last_add_locked(self) -> None:
        g = self._tiered_len + self._hot_len
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
        for seg in reversed(self._bases + self._cold):
            if seg.n_adds:
                self._last_add = seg.start + int(seg.add_pos.max())
                return
        self._last_add = None

    # -- spill / compaction / GC ------------------------------------------

    def _spill_excess_locked(self) -> Tuple[int, bool]:
        """``(excess_ops, due)`` under the hot op/byte budgets."""
        cfg = self._cfg
        excess = self._hot_len - cfg.hot_ops
        due = excess >= max(1, cfg.hot_ops // 4)
        if cfg.hot_bytes and self._hot_len > 1:
            hb = self._hot_bytes_locked()
            # the byte path's hysteresis is BYTE-denominated: with
            # large per-op values, waiting for hot_ops//4 excess
            # OPS would overshoot the byte budget many times over
            if hb - cfg.hot_bytes > cfg.hot_bytes // 4:
                per = hb / self._hot_len
                excess = max(excess,
                             int((hb - cfg.hot_bytes) / per))
                due = excess > 0
        return excess, due

    def maybe_spill(self) -> bool:
        """Spill the hot tail past its budget (and, when due, advance
        the checkpoint base + GC watermark-cleared segments).  Called by
        the engine at commit boundaries only — never mid-batch or
        mid-chunked-apply, so a rollback's target range is always still
        hot.  Returns True when ops moved to disk (the owner should
        drop any full-packing cache).

        With a deferred spill policy armed (:meth:`set_spill_policy`),
        a due spill is handed to the maintenance worker instead — the
        O(hot tail) seal (and the fold/GC behind it) leaves the
        calling thread entirely — UNLESS the hot tail has breached the
        hard cap (the worker is lagging), in which case the spill runs
        inline so resident memory stays bounded regardless."""
        cfg = self._cfg
        if cfg is None:
            return False
        spilled = False
        deferred = inline_fallback = False
        with self._mu:
            excess, due = self._spill_excess_locked()
            if due and excess > 0:
                below_cap = (self._hard_cap_ops <= 0
                             or self._hot_len < self._hard_cap_ops) \
                    and (self._hard_cap_bytes <= 0
                         or self._hot_bytes_locked()
                         < self._hard_cap_bytes)
                if self._defer_cb is not None and below_cap:
                    deferred = True
                else:
                    inline_fallback = self._defer_cb is not None
                    self._spill_locked(min(excess, self._hot_len))
                    spilled = True
            if cfg.auto_stable:
                self._stable = self._len
            if self._defer_cb is None or inline_fallback:
                # deferred mode leaves fold/GC to the worker (it runs
                # them behind each spill task) — EXCEPT on the
                # hard-cap inline fallback: the worker is lagging or
                # wedged, so cleanup must not wait on it either
                self._gc_locked()
                self._sweep_tombs_locked()
        self._fire_advance()
        if inline_fallback and self._inline_cb is not None:
            try:
                self._inline_cb()
            except Exception:   # noqa: BLE001 — owner callback boundary
                pass
        if deferred and self._defer_cb is not None:
            try:
                self._defer_cb()
            except Exception:   # noqa: BLE001 — owner callback boundary
                pass
        if spilled and self._on_spill is not None:
            try:
                self._on_spill()
            except Exception:   # noqa: BLE001 — owner callback boundary
                pass
        return spilled

    def spill_to(self, extent: int,
                 keep_hot: Optional[int] = None) -> bool:
        """Background-worker spill (serve/workers.py): seal hot ops
        into cold segments WITHOUT advancing the tiered extent past
        ``extent`` — rows at or past it may still be rolled back by a
        failed group-commit fsync, so the worker only ever spills rows
        the scheduler has proven durable (``ServedDoc`` safe extent).
        ``keep_hot`` overrides the budget floor (0 = drain the whole
        eligible tail, the age/resident-bytes policy sweeps).  Runs
        fold/GC and tomb sweeping afterwards, exactly like the inline
        commit-boundary path did.  Returns True when ops moved to
        disk."""
        spilled = False
        with self._mu:
            cfg = self._cfg
            if cfg is None:
                return False
            keep = cfg.hot_ops if keep_hot is None else max(0, keep_hot)
            k = min(self._hot_len - keep,
                    max(0, int(extent) - self._tiered_len),
                    self._hot_len)
            if k > 0:
                self._spill_locked(k)
                spilled = True
            # chaos site: the background worker's spill landed (new
            # manifest referencing the sealed segments) but the fold/GC
            # pass has not run — recovery reopens the manifest and
            # replays the WAL tail past it (docs/DURABILITY.md)
            _maybe_crash("mid-bg-fold")
            self._gc_locked()
            self._sweep_tombs_locked()
        self._fire_advance()
        if spilled and self._on_spill is not None:
            try:
                self._on_spill()
            except Exception:   # noqa: BLE001 — owner callback boundary
                pass
        return spilled

    def set_on_spill(self, cb: Optional[Callable[[], None]]) -> None:
        self._on_spill = cb

    def set_spill_policy(self, defer_cb: Optional[Callable[[], None]],
                         inline_cb: Optional[Callable[[], None]] = None,
                         hard_cap_ops: int = 0,
                         hard_cap_bytes: int = 0) -> None:
        """Arm (or disarm, ``defer_cb=None``) the deferred spill
        policy: due spills are handed to ``defer_cb`` (the maintenance
        worker's enqueue) instead of sealing inline, with an inline
        fallback past ``hard_cap_ops`` resident hot ops — or past
        ``hard_cap_bytes`` resident hot bytes, the twin cap for
        byte-budgeted tails (few huge ops would never trip the op
        count) — (``inline_cb`` counts those; memory stays bounded
        even when the worker lags)."""
        with self._mu:
            self._defer_cb = defer_cb
            self._inline_cb = inline_cb
            self._hard_cap_ops = max(0, int(hard_cap_ops))
            self._hard_cap_bytes = max(0, int(hard_cap_bytes))

    def spill_due(self) -> bool:
        """Whether the hot tail is past its spill budget right now —
        the WAL-sync worker re-checks after each fsync advances the
        spill-safe extent (a spill task capped at the old extent may
        have left the tail over budget)."""
        with self._mu:
            if self._cfg is None:
                return False
            excess, due = self._spill_excess_locked()
            return due and excess > 0

    @property
    def hot_len(self) -> int:
        with self._mu:
            return self._hot_len

    def hot_bytes(self) -> int:
        """Resident bytes of the hot tail alone (the engine-wide
        resident-budget policy ranks documents by this)."""
        with self._mu:
            return self._hot_bytes_locked()

    def hot_age_s(self) -> float:
        """Seconds the (approximate) oldest hot op has been resident —
        0.0 for an empty tail.  The age-based spill policy
        (``GRAFT_OPLOG_HOT_AGE_S``) sweeps tails past this."""
        with self._mu:
            if not self._hot_len or self._hot_since is None:
                return 0.0
            return time.monotonic() - self._hot_since

    def set_durable_hooks(self, meta_cb: Optional[Callable[[], dict]],
                          on_advance: Optional[Callable[[int], None]]
                          ) -> None:
        """Durable mode wiring (serve/engine.py ``ServedDoc``):
        ``meta_cb()`` supplies the clock/cursor meta stamped into each
        manifest write; ``on_advance(tiered_len)`` fires after a
        manifest made rows below ``tiered_len`` durable in the tiers —
        the owner truncates the WAL prefix they cover."""
        with self._mu:
            self._meta_cb = meta_cb
            self._on_advance = on_advance

    # -- persisted materialization (engine.TpuTree writes the file) ------

    @property
    def matz_entry(self) -> Optional[dict]:
        """The manifest's persisted-materialization entry
        (``{"file", "len"}``) or None."""
        with self._mu:
            return dict(self._matz) if self._matz is not None else None

    def next_matz_name(self) -> str:
        """A fresh artifact file name (never collides with the live
        entry, so a crash mid-write can't corrupt a referenced
        artifact)."""
        with self._mu:
            self._matz_seq += 1
            return f"matz-g{self._matz_seq}.npz"

    def spill_all(self) -> None:
        """Seal the ENTIRE hot tail into cold segments now (manifest
        rewritten in durable mode).  The materialization writer calls
        this first so the artifact's coverage is ≤ the tiered extent —
        a restore then always finds every covered op in the tiers, and
        the artifact can never resurrect ops that only ever lived in
        an unsynced WAL tail."""
        with self._mu:
            if self._cfg is None:
                return
            if self._hot_len:
                self._spill_locked(self._hot_len)
        self._fire_advance()
        if self._on_spill is not None:
            try:
                self._on_spill()
            except Exception:   # noqa: BLE001 — owner callback boundary
                pass

    def note_matz(self, file_name: str, length: int) -> None:
        """Record a freshly written (and fsynced, in durable mode)
        materialization artifact and publish it atomically in the
        manifest.  The previous artifact file is deleted only AFTER
        the manifest stops referencing it."""
        with self._mu:
            cfg = self._cfg
            if cfg is None:
                raise ValueError("note_matz requires tiering")
            if length > self._len:
                raise ValueError(
                    f"matz covers {length} ops; log holds {self._len}")
            if self._matz is not None:
                self._matz_tombs.append(
                    os.path.join(cfg.dir, self._matz["file"]))
            self._matz = {"file": file_name, "len": int(length)}
            if cfg.durable:
                self._durable_manifest_locked()
        self._fire_advance()

    def _drop_matz_locked(self) -> None:
        if self._matz is not None and self._cfg is not None:
            self._matz_tombs.append(
                os.path.join(self._cfg.dir, self._matz["file"]))
        self._matz = None

    def _write_manifest_locked(self, target: str, length: int,
                               meta: dict) -> str:
        """Atomically (re)write ``manifest.json`` describing the
        current tier layout.  Durable mode fsyncs the tmp before the
        rename so a crash leaves either the old or the new manifest,
        never a torn one (the ``mid-manifest-write`` kill site sits
        between the two, proving exactly that)."""
        import json
        manifest = {
            "version": 2,
            "length": length,
            # v1 compatibility slot (single-file base); v2 readers use
            # base_chunks and ignore it
            "base": None,
            "base_chunks": [{"file": os.path.basename(cs.path),
                             "start": cs.start, "len": cs.length,
                             **(_quarantine_manifest_extra(cs)
                                if cs.quarantined else {})}
                            for cs in self._bases],
            "segments": [{"file": os.path.basename(cs.path),
                          "start": cs.start, "len": cs.length,
                          **(_quarantine_manifest_extra(cs)
                             if cs.quarantined else {})}
                         for cs in self._cold],
            "matz": dict(self._matz) if self._matz is not None
            else None,
            "meta": meta,
        }
        path = os.path.join(target, "manifest.json")
        tmp = path + ".tmp"
        durable = self._cfg is not None and self._cfg.durable
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            if durable:
                f.flush()
                os.fsync(f.fileno())
        _maybe_crash("mid-manifest-write")
        os.replace(tmp, path)
        if durable:
            # directory fsync: the renamed manifest AND the freshly
            # sealed segment entries it references must survive a
            # POWER loss, not just a process kill
            from .wal import _fsync_dir
            _fsync_dir(target)
        # superseded materialization artifacts (full paths in the live
        # dir): unreferenced the moment the rename landed — delete
        # best-effort
        tombs, self._matz_tombs = self._matz_tombs, []
        for fp in tombs:
            try:
                os.remove(fp)
            except OSError:
                pass
        return path

    def _durable_manifest_locked(self) -> None:
        """Durable layout change: persist the manifest (tiers only —
        the WAL covers the hot tail) and remember the new tiered
        extent for the post-lock ``on_advance`` callback."""
        cfg = self._cfg
        if cfg is None or not cfg.durable:
            return
        meta = {}
        if self._meta_cb is not None:
            try:
                meta = self._meta_cb()
            except Exception:   # noqa: BLE001 — owner callback boundary
                meta = {}
        self._write_manifest_locked(cfg.dir, self._tiered_len, meta)
        self._advance_pending = self._tiered_len

    def _fire_advance(self) -> None:
        """Run the deferred ``on_advance`` callback outside the tier
        lock (it truncates the WAL — file I/O under its own lock)."""
        adv = getattr(self, "_advance_pending", None)
        self._advance_pending = None
        if adv is not None and self._on_advance is not None:
            try:
                self._on_advance(adv)
            except Exception:   # noqa: BLE001 — owner callback boundary
                pass

    def _spill_locked(self, k: int) -> None:
        """Seal the first ``k`` hot ops into ``~hot_ops``-sized cold
        segment files (bounded-segment GC granularity, bounded cold
        catch-up reads) — the whole prefix is taken in ONE pass, so a
        giant backlog costs one consolidation copy, not a re-copy of
        the shrinking remainder per segment.  Split segments are
        REPLACED by copies so views pinning the originals stay
        intact."""
        cfg = self._cfg
        take: List[Segment] = []
        left = k
        i = 0
        while left > 0 and i < len(self._segs):
            seg = self._segs[i]
            ln = len(seg)
            if ln <= left:
                take.append(seg)
                left -= ln
                i += 1
            else:
                if isinstance(seg, list):
                    take.append(seg[:left])
                    self._segs[i] = seg[left:]
                else:
                    take.append(_PackedSeg(seg.packed, seg.start,
                                           seg.start + left))
                    # COMPACT the remainder: keeping a row range of the
                    # original would pin the whole ingest batch's
                    # columns resident, defeating the spill (only
                    # still-live views keep the original alive)
                    rem = packed_mod.select_rows(
                        seg.packed,
                        np.arange(seg.start + left, seg.stop))
                    self._segs[i] = _PackedSeg(rem, 0, rem.num_ops)
                left = 0
        del self._segs[:i]
        k -= left
        if k <= 0:
            return
        parts: List[PackedOps] = []
        for seg in take:
            if isinstance(seg, list):
                parts.append(packed_mod.pack(
                    seg, max_depth=cfg.max_depth))
            elif seg.start == 0 and seg.stop == seg.packed.num_ops:
                parts.append(seg.packed)
            else:
                parts.append(packed_mod.select_rows(
                    seg.packed, np.arange(seg.start, seg.stop)))
        p = packed_mod.concat_many(parts)
        seg_ops = max(cfg.hot_ops, 1)
        for s in range(0, k, seg_ops):
            e = min(s + seg_ops, k)
            piece = p if (s == 0 and e == p.num_ops) else \
                packed_mod.select_rows(p, np.arange(s, e))
            start = self._tiered_len
            self._file_seq += 1
            path = os.path.join(
                cfg.dir, f"seg-{start:012d}-{e - s}-"
                         f"{self._file_seq}.npz")
            self._cold.append(
                _ColdSeg.seal(piece, start, path, self._cache,
                              fsync=cfg.durable))
            self._tiered_len += e - s
            self._hot_len -= e - s
            self.spills += 1
            # chaos site: segment file(s) sealed, manifest NOT yet
            # written — recovery must reopen the OLD manifest and
            # replay the untruncated WAL over it (the stray files are
            # unreferenced and harmlessly overwritten later)
            _maybe_crash("mid-spill")
        # the age clock restarts: the spilled prefix was the oldest
        self._hot_since = time.monotonic() if self._hot_len else None
        self._durable_manifest_locked()

    def run_gc(self) -> None:
        """Checkpoint advancement + segment GC, gated by the stability
        watermark.  Safe from any thread (the fleet's anti-entropy
        thread drives it after each mark exchange)."""
        with self._mu:
            self._gc_locked()
            self._sweep_tombs_locked()
        self._fire_advance()

    def _gc_locked(self) -> None:
        cfg = self._cfg
        if cfg is None or not self._cold:
            return
        stable = self._stable_locked()
        fold: List[_ColdSeg] = []
        for cs in self._cold:
            if cs.quarantined:
                # an unreadable (bit-rotted, repair-pending) segment
                # cannot fold; everything after it waits too — the
                # base must stay a readable contiguous prefix
                break
            if cs.start + cs.length <= stable:
                fold.append(cs)
            else:
                break
        if len(fold) < cfg.gc_min_segs:
            return
        # chunked base: the fold APPENDS bounded chunks — write
        # amplification is capped at one partial last chunk rewritten
        # per fold (never the whole base, which the pre-chunk layout
        # re-copied in full and therefore had to gate at base/2)
        chunk_ops = cfg.base_chunk_ops
        parts: List[PackedOps] = []
        new_bases = list(self._bases)
        rewritten: List[_ColdSeg] = []
        if new_bases and new_bases[-1].length < chunk_ops \
                and not new_bases[-1].quarantined:
            # merge the trailing partial chunk with the fold input so
            # chunks stay densely packed (bounded catch-up reads)
            tail = new_bases.pop()
            rewritten.append(tail)
            parts.append(tail.load(use_cache=False))
        parts.extend(cs.load(use_cache=False) for cs in fold)
        merged = packed_mod.concat_many(parts)
        start0 = (new_bases[-1].start + new_bases[-1].length) \
            if new_bases else 0
        for s in range(0, merged.num_ops, chunk_ops):
            e = min(s + chunk_ops, merged.num_ops)
            piece = merged if (s == 0 and e == merged.num_ops) else \
                packed_mod.select_rows(merged, np.arange(s, e))
            self._base_gen += 1
            path = os.path.join(
                cfg.dir, f"base-{start0 + s:012d}-{e - s}-"
                         f"g{self._base_gen}.npz")
            new_bases.append(_ColdSeg.seal(piece, start0 + s, path,
                                           self._cache,
                                           fsync=cfg.durable))
        # chaos site: the folded chunks exist on disk but the manifest
        # still references the old layout — whose files are only
        # deleted AFTER the manifest write below, so recovery from the
        # old manifest always finds its files
        _maybe_crash("mid-fold")
        self._tombs.extend(rewritten)
        self._tombs.extend(fold)
        self._bases = new_bases
        del self._cold[:len(fold)]
        self.compactions += 1
        self.segments_gc += len(fold)
        self._durable_manifest_locked()

    def _sweep_tombs_locked(self) -> None:
        """Delete folded/replaced segment files whose descriptors no
        live view pins; pinned ones retry next sweep (reference-stable
        GC — an in-flight window chain keeps its files)."""
        if not self._tombs:
            self.gc_deferred = 0
            return
        alive = list(self._views)
        keep: List[_ColdSeg] = []
        for seg in self._tombs:
            if any(v.references(seg) for v in alive):
                keep.append(seg)
                continue
            if self._cache is not None:
                self._cache.drop(seg.path)
            try:
                os.remove(seg.path)
            except OSError:
                pass
            drop_wire_sidecars(seg.path)
        self._tombs = keep
        self.gc_deferred = len(keep)

    # -- scrub & quarantine (docs/DURABILITY.md §Scrub & repair) ----------

    def scrub(self) -> Dict[str, Any]:
        """Re-verify the checksums of every cold segment, base chunk,
        and the matz artifact (the bit-rot sweep the maintenance
        worker runs on a cadence).  A corrupt TIER file is quarantined
        — its descriptor refuses every load and the manifest is
        atomically rewritten so a restart inherits the quarantine —
        and left for :meth:`repair_segment` to heal from a fleet peer.
        A corrupt MATZ artifact is simply dropped from the manifest:
        it is derived data, and the next cadence refresh regenerates
        it (the single-node "warned fallback" taxonomy).  File reads
        run OUTSIDE the tier lock; quarantine decisions re-check the
        descriptor under it."""
        report: Dict[str, Any] = {
            "checked": 0, "ok": 0, "corrupt": 0,
            "matz_dropped": 0, "quarantined": 0, "reasons": []}
        cfg = self._cfg
        if cfg is None:
            return report
        with self._mu:
            targets = [s for s in self._bases + self._cold
                       if not s.quarantined]
            matz = dict(self._matz) if self._matz is not None else None
        corrupt: List[Tuple[_ColdSeg, str]] = []
        for seg in targets:
            report["checked"] += 1
            reason = packed_mod.verify_packed_npz(
                seg.path, expect_ops=seg.length)
            if reason is None:
                report["ok"] += 1
            else:
                corrupt.append((seg, reason))
                report["reasons"].append(
                    f"{os.path.basename(seg.path)}: {reason}")
        matz_bad: Optional[str] = None
        if matz is not None:
            report["checked"] += 1
            matz_bad = packed_mod.verify_packed_npz(
                os.path.join(cfg.dir, matz["file"]))
            if matz_bad is None:
                report["ok"] += 1
            else:
                report["reasons"].append(
                    f"{matz['file']}: {matz_bad}")
        if corrupt or matz_bad is not None:
            with self._mu:
                changed = False
                live = set(map(id, self._bases + self._cold))
                for seg, _reason in corrupt:
                    if seg.quarantined or id(seg) not in live:
                        # a concurrent fold/GC legitimately rewrote or
                        # deleted the file the lock-free verify read —
                        # a retired descriptor is not bit-rot
                        continue
                    seg.quarantined = True
                    self.quarantines += 1
                    report["corrupt"] += 1
                    if self._cache is not None:
                        # a cached copy predates the corruption, but a
                        # quarantined range must have ONE truth: the
                        # typed refusal until repair lands
                        self._cache.drop(seg.path)
                    changed = True
                if matz_bad is not None and self._matz is not None \
                        and self._matz["file"] == matz["file"]:
                    self._drop_matz_locked()
                    report["matz_dropped"] = 1
                    changed = True
                if changed:
                    self._durable_manifest_locked()
            self._fire_advance()
        with self._mu:
            report["quarantined"] = sum(
                1 for s in self._bases + self._cold if s.quarantined)
        return report

    def quarantined_segments(self) -> List[_ColdSeg]:
        """Live quarantined descriptors (this scrub's finds plus any
        inherited from a restart) — the repair loop's work list."""
        with self._mu:
            return [s for s in self._bases + self._cold
                    if s.quarantined]

    def repair_spec(self, seg: _ColdSeg) -> Optional[Dict[str, int]]:
        """The peer-fetch entry point for a quarantined segment's row
        range: ``since`` = the last Add timestamp strictly BEFORE the
        range (resolved from the neighboring tiers' resident add
        indexes — no disk touch), ``p0`` its global position; 0/0 when
        no prior Add resolves (the fetch then chains from the log's
        first window — more rows, same answer)."""
        with self._mu:
            if not seg.quarantined:
                return None
            since = p0 = 0
            prior = [s for s in self._bases + self._cold
                     if s.start < seg.start]
            for other in reversed(prior):
                if other.quarantined or other.n_adds == 0:
                    continue
                i = int(np.argmax(other.add_pos))
                since = int(other.add_ts[i])
                p0 = other.start + int(other.add_pos[i])
                break
            return {"start": seg.start,
                    "stop": seg.start + seg.length,
                    "since": since, "p0": p0}

    def repair_segment(self, seg: _ColdSeg, p: PackedOps) -> bool:
        """Heal a quarantined segment with rows re-fetched from a
        fleet peer: cross-check them against the descriptor's resident
        add index (built from the file when it was still healthy —
        a diverged peer's rows are REFUSED, the quarantine stands),
        seal a fresh file, swap the descriptor's backing in place
        (every pinned view heals with it — the rows are identical by
        construction), and atomically rewrite the manifest.  The
        corrupt file is deleted only after the manifest stopped
        referencing anything at its path."""
        with self._mu:
            cfg = self._cfg
            if cfg is None or not seg.quarantined:
                return False
            n = p.num_ops
            if n != seg.length:
                return False
            add_ts, add_pos = _ColdSeg._add_index(p.kind[:n],
                                                  p.ts[:n])
            if seg.index_ok and (
                    not np.array_equal(add_ts, seg.add_ts)
                    or not np.array_equal(add_pos, seg.add_pos)):
                return False
            self._file_seq += 1
            path = os.path.join(
                cfg.dir, f"seg-{seg.start:012d}-{seg.length}-"
                         f"{self._file_seq}.npz")
        # the O(chunk) serialize + fsync runs OUTSIDE the tier lock —
        # a repair must never stall the doc's commit/read paths for a
        # whole disk write (the maintenance-lane rule)
        fresh = _ColdSeg.seal(p, seg.start, path, self._cache,
                              fsync=cfg.durable)
        with self._mu:
            if not seg.quarantined:
                # raced another repair of the same slot: ours loses
                try:
                    os.remove(path)
                except OSError:
                    pass
                return False
            old_path = seg.path
            seg.add_ts, seg.add_pos = fresh.add_ts, fresh.add_pos
            seg.file_bytes = fresh.file_bytes
            seg.hints_vouched = fresh.hints_vouched
            seg.index_ok = True
            # path before the flag: a racing reader that sees the
            # quarantine lifted must already be pointed at the fresh
            # file, never the corrupt one
            seg.path = fresh.path
            seg.quarantined = False
            # any wire sidecar belonged to the replaced file: reset to
            # unprobed so the next cold window rebuilds from the
            # healthy bytes (and delete the stale pair below)
            seg.wire = None
            self.repairs += 1
            self._durable_manifest_locked()
            if old_path != path:
                try:
                    os.remove(old_path)
                except OSError:
                    pass
                drop_wire_sidecars(old_path)
        self._fire_advance()
        return True

    # -- views ------------------------------------------------------------

    def _view_locked(self, max_depth: int = DEFAULT_MAX_DEPTH
                     ) -> LogView:
        parts: List[_ViewPart] = []
        g = 0
        for cs in self._bases:
            parts.append(("cold", cs, 0, cs.length, g))
            g += cs.length
        for cs in self._cold:
            parts.append(("cold", cs, 0, cs.length, g))
            g += cs.length
        for seg in self._segs:
            if isinstance(seg, list):
                hi = len(seg)
                parts.append(("obj", seg, 0, hi, g))
                g += hi
            else:
                parts.append(("packed", seg.packed, seg.start,
                              seg.stop, g))
                g += seg.stop - seg.start
        v = LogView(tuple(parts), g, self._last_add, max_depth)
        self._views.add(v)
        return v

    def view(self, max_depth: int = DEFAULT_MAX_DEPTH) -> LogView:
        """Freeze the current layout into an immutable, reference-
        stable :class:`LogView` — what a published ``DocSnapshot``
        pins, and what every read below resolves through."""
        with self._mu:
            return self._view_locked(max_depth)

    # -- readers ----------------------------------------------------------

    def __len__(self) -> int:
        return self._len

    @property
    def num_segments(self) -> int:
        """Physical segment count across all tiers — the
        log-fragmentation signal the serving metrics export: chunked
        merges and coalesced commits append one column segment per
        launch, and full-column re-export cost scales with it."""
        with self._mu:
            return len(self._bases) + len(self._cold) + len(self._segs)

    def __bool__(self) -> bool:
        return self._len > 0

    def __iter__(self) -> Iterator[Operation]:
        return self.view().iter_ops()

    def materialize(self, start: int, stop: int) -> List[Operation]:
        """Operation objects for rows ``[start, stop)`` — touches only
        the overlapped segments (cold ones load through the LRU)."""
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
        ``operations_since`` terminator), or None.  Applied logs hold
        each add timestamp at most once (duplicates absorb before
        reaching the log), so first == newest; packed segments answer
        from their cached column index, object segments by scan, cold
        tiers from the resident add index without touching disk."""
        return self.view().index_of_add(ts)

    def as_batch(self) -> Batch:
        """The whole log as one Batch — lazily (a PackedBatch over the
        columns) when the log is a single in-memory column segment, so
        a bootstrap-restored document answering ``operations_since(0)``
        through the OBJECT api doesn't materialize a million ops the
        caller may never touch; otherwise a plain materialized Batch."""
        with self._mu:
            if not self._bases and not self._cold \
                    and len(self._segs) == 1 \
                    and not isinstance(self._segs[0], list):
                seg = self._segs[0]
                return PackedBatch(seg.packed, seg.start, seg.stop)
            v = self._view_locked()
        return Batch(tuple(v.iter_ops()))

    def tail_is(self, pb: PackedBatch) -> bool:
        """True iff ``pb`` wraps exactly this log's final (hot) segment
        rows — the O(1) identity check behind the binary checkpoint's
        ``last_op_span`` fast path (engine.checkpoint_packed)."""
        with self._mu:
            if not self._segs or pb.num_leaves == 0:
                return False
            seg = self._segs[-1]
            return (isinstance(seg, _PackedSeg)
                    and seg.packed is pb._packed
                    and pb._stop == seg.stop
                    and pb._start >= seg.start)

    # -- column export ----------------------------------------------------

    @profiling.span("oplog.to_packed")
    def to_packed(self, max_depth: int = DEFAULT_MAX_DEPTH
                  ) -> PackedOps:
        """The whole log as one PackedOps — object runs pack, in-memory
        column segments slice, cold tiers load, and
        ``packed.concat_many`` unions everything in ONE allocation
        (cross-resolving link hints, so the result stays vouched when
        every piece is)."""
        return self.view(max_depth).to_packed()

    # -- tiered checkpoint (persist / open) --------------------------------

    def persist(self, meta: dict, dir: Optional[str] = None,
                matz: Optional[dict] = None) -> str:
        """Tiered checkpoint: spill the remaining hot tail to a final
        segment and write ``manifest.json`` (tier layout + caller
        ``meta``).  Bootstrap then re-opens descriptors
        (:meth:`open_dir`) instead of replaying history.  Requires
        tiering enabled.  ``matz`` (``{"file", "len"}``) records a
        persisted-materialization artifact the caller already wrote
        into the target dir — the manifest versions it atomically with
        the tier layout.

        With ``dir`` set to somewhere OTHER than the live tier dir,
        the segment files are COPIED there and the manifest written
        against the copies — the checkpoint then survives this log's
        lifecycle (a served document's tier dir is ephemeral scratch,
        deleted with the engine; a checkpoint must not live in it)."""
        with self._mu:
            cfg = self._cfg
            if cfg is None:
                raise ValueError(
                    "persist() requires tiering — call enable_tiering "
                    "first")
            if self._hot_len:
                self._spill_locked(self._hot_len)
            target = cfg.dir if dir is None else dir
            if target != cfg.dir:
                import shutil
                os.makedirs(target, exist_ok=True)
                segs = self._bases + self._cold
                for cs in segs:
                    shutil.copyfile(cs.path, os.path.join(
                        target, os.path.basename(cs.path)))
                if matz is None and self._matz is not None:
                    # carry the live artifact with the checkpoint
                    src = os.path.join(cfg.dir, self._matz["file"])
                    try:
                        shutil.copyfile(src, os.path.join(
                            target, self._matz["file"]))
                        matz = dict(self._matz)
                    except OSError:
                        matz = None
            if matz is not None:
                if int(matz.get("len", -1)) > self._len:
                    raise ValueError(
                        f"matz entry covers {matz.get('len')!r} ops; "
                        f"log holds {self._len}")
                if target == cfg.dir:
                    if self._matz is not None \
                            and self._matz["file"] != matz["file"]:
                        self._matz_tombs.append(os.path.join(
                            cfg.dir, self._matz["file"]))
                    self._matz = dict(matz)
            saved = self._matz
            if target != cfg.dir:
                # write the foreign manifest against the caller's (or
                # copied) entry without disturbing the live one
                self._matz = dict(matz) if matz is not None else None
            try:
                return self._write_manifest_locked(target, self._len,
                                                   meta)
            finally:
                if target != cfg.dir:
                    self._matz = saved

    @classmethod
    def open_dir(cls, dir: str, **tier_kw) -> Tuple["OpLog", dict]:
        """Open a persisted cascade: descriptors + resident add indexes
        only (each segment file contributes one light ``kind``/``ts``
        read) — O(tail) memory, no replay.  Returns ``(log, meta)``.
        Any missing/corrupt/inconsistent piece raises a typed
        :class:`CheckpointError` — never a silent partial log."""
        import json
        path = os.path.join(dir, "manifest.json")
        try:
            with open(path) as f:
                manifest = json.load(f)
            length = manifest["length"]
            base_e = manifest.get("base")
            chunk_es = manifest.get("base_chunks")
            seg_es = manifest["segments"]
            if not isinstance(length, int) or isinstance(length, bool):
                raise ValueError(f"manifest length {length!r}")
            if not isinstance(seg_es, list):
                raise ValueError("manifest segments not a list")
            if chunk_es is None:
                # v1 manifest: a single monolithic base file
                chunk_es = [] if base_e is None else \
                    [{"file": base_e["file"], "start": 0,
                      "len": base_e["len"]}]
            if not isinstance(chunk_es, list):
                raise ValueError("manifest base_chunks not a list")
            # NOTE: matz coverage is deliberately NOT bounded by the
            # manifest length here — a rollback truncate can shrink
            # the tiered extent below an artifact the WAL tail still
            # re-extends past, and an over-covering artifact must
            # degrade to the lazy first-read fallback (MatzWarning),
            # never brick the whole restore
            matz_e = manifest.get("matz")
            if matz_e is not None and not (
                    isinstance(matz_e, dict)
                    and isinstance(matz_e.get("file"), str)
                    and isinstance(matz_e.get("len"), int)
                    and not isinstance(matz_e.get("len"), bool)
                    and matz_e["len"] >= 0):
                raise ValueError(f"manifest matz entry {matz_e!r}")
        except (OSError, ValueError, TypeError, KeyError,
                json.JSONDecodeError) as e:
            raise CheckpointError(
                f"op-log manifest {path!r} unreadable: "
                f"{type(e).__name__}: {e}") from e
        log = cls()
        log.enable_tiering(dir, **tier_kw)
        running = 0
        with log._mu:
            for e in chunk_es:
                if e["start"] != running:
                    raise CheckpointError(
                        f"op-log manifest {path!r}: base chunk "
                        f"{e['file']!r} starts at {e['start']}, "
                        f"expected {running}")
                fp = os.path.join(dir, e["file"])
                log._bases.append(
                    _ColdSeg.placeholder(fp, e["start"], e["len"],
                                         log._cache,
                                         *(_decode_quarantine_index(e)
                                           or (None, None)))
                    if e.get("quarantined") else
                    _ColdSeg.open(fp, e["start"], e["len"],
                                  log._cache))
                running += e["len"]
            for e in seg_es:
                if e["start"] != running:
                    raise CheckpointError(
                        f"op-log manifest {path!r}: segment "
                        f"{e['file']!r} starts at {e['start']}, "
                        f"expected {running}")
                fp = os.path.join(dir, e["file"])
                log._cold.append(
                    _ColdSeg.placeholder(fp, e["start"], e["len"],
                                         log._cache,
                                         *(_decode_quarantine_index(e)
                                           or (None, None)))
                    if e.get("quarantined") else
                    _ColdSeg.open(fp, e["start"], e["len"],
                                  log._cache))
                running += e["len"]
            log._matz = dict(matz_e) if matz_e is not None else None
            if running != length:
                raise CheckpointError(
                    f"op-log manifest {path!r}: tiers hold {running} "
                    f"ops, manifest says {length}")
            log._tiered_len = running
            log._len = running
            log._hot_len = 0
            log._recompute_last_add_locked()
            if log._cfg.auto_stable:
                log._stable = running
            # resume file numbering past anything on disk — including
            # stray files a crash left sealed but unreferenced (a new
            # seal must never clobber a manifest-referenced file, and
            # overwriting strays silently is fine only because names
            # never collide with live descriptors)
            import re as _re
            for fn in os.listdir(dir):
                m = _re.match(r"seg-\d+-\d+-(\d+)\.npz$", fn)
                if m:
                    log._file_seq = max(log._file_seq, int(m.group(1)))
                m = _re.match(r"base-[0-9-]+-g(\d+)\.npz$", fn)
                if m:
                    log._base_gen = max(log._base_gen, int(m.group(1)))
                m = _re.match(r"matz-g(\d+)\.npz$", fn)
                if m:
                    log._matz_seq = max(log._matz_seq, int(m.group(1)))
                    if log._matz is None or fn != log._matz["file"]:
                        # a stray the manifest never published (crash
                        # at mid-matz-write, or a superseded artifact
                        # whose tomb sweep never ran): each is
                        # O(document state) on disk — delete now, the
                        # seq counter above already skips past it
                        try:
                            os.remove(os.path.join(dir, fn))
                        except OSError:
                            pass
        return log, manifest.get("meta", {})

    # -- telemetry ---------------------------------------------------------

    def _hot_bytes_locked(self) -> int:
        total = 0
        seen = set()
        for seg in self._segs:
            if isinstance(seg, list):
                total += _OBJ_OP_BYTES * len(seg)
            else:
                pid = id(seg.packed)
                if pid not in seen:
                    seen.add(pid)
                    total += _packed_resident(seg.packed)
        return total

    def resident_bytes(self) -> int:
        """Estimated resident bytes of the log: hot columns/objects,
        cold-tier add indexes, and the loaded-segment cache.  The SAME
        estimator prices an untiered log (everything is then hot), so
        the memory-bound guard and the headline bench compare one
        ruler."""
        return self.telemetry()["resident_bytes"]

    def telemetry(self) -> Dict[str, Any]:
        """Counter/gauge snapshot (``crdt_oplog_*`` prom families +
        per-doc ``/metrics`` key).  JSON-safe."""
        with self._mu:
            tiers = self._bases + self._cold
            hot_b = self._hot_bytes_locked()
            idx_b = sum(cs.index_bytes() for cs in tiers)
            if self._cache is None:
                cache_b = loads = evictions = 0
            elif self._cache_shared:
                # own entries/counters only — a shared cache's totals
                # belong to the engine, not to every doc's series at
                # once (prom sums over the doc label)
                own = [cs.path for cs in tiers + self._tombs]
                cache_b = self._cache.resident_bytes_for(own)
                loads = self._cache.loads_for_dir(self._cfg.dir)
                evictions = self._cache.evictions_for_dir(
                    self._cfg.dir)
            else:
                cache_b = self._cache.resident_bytes()
                loads = self._cache.loads
                evictions = self._cache.evictions
            return {
                "tiered": self._cfg is not None,
                "hot_ops": self._hot_len,
                "cold_ops": sum(cs.length for cs in self._cold),
                "base_ops": sum(cs.length for cs in self._bases),
                "hot_bytes": hot_b,
                "index_bytes": idx_b,
                "cache_bytes": cache_b,
                "resident_bytes": hot_b + idx_b + cache_b,
                "cold_file_bytes": sum(cs.file_bytes
                                       for cs in self._cold),
                "base_file_bytes": sum(cs.file_bytes
                                       for cs in self._bases),
                "segments": {"hot": len(self._segs),
                             "cold": len(self._cold),
                             "base": len(self._bases)},
                "spills": self.spills,
                "compactions": self.compactions,
                "segments_gc": self.segments_gc,
                "gc_deferred": self.gc_deferred,
                # scrub & quarantine (docs/DURABILITY.md §Scrub)
                "quarantines": self.quarantines,
                "repairs": self.repairs,
                "quarantined": sum(
                    1 for s in self._bases + self._cold
                    if s.quarantined),
                "segment_loads": loads,
                "cache_evictions": evictions,
                "load_ms": self._cache.hist_export()
                if self._cache is not None else None,
                "stable_mark": self._stable_locked(),
                "matz_len": int(self._matz["len"])
                if self._matz is not None else 0,
            }
