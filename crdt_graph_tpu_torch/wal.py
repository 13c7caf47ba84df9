"""Per-document write-ahead log: crash-durable acked writes.

The port of the reference package's ``wal`` (framework-free; its lazy
imports point at this package's codec and errors).  Records,
truncation and the crash sites are the reference's, byte for byte: a WAL
written by either package replays into the other (pinned by
tests/test_torch_wal.py).

The cascade op-log (oplog.py) bounds *resident* memory, but until a
spill fires every acked write lives only in the in-memory hot tail.
This module closes that window: a durable writer appends every commit's
applied ops to the document's WAL and fsyncs **before the ack is
released**, so the durable-ack contract holds at every kill point:

- **record format** — an 8-byte file magic, then length-prefixed
  checksummed records: ``u32 payload_len | u32 crc32(payload)`` followed
  by the payload, which is an 8-byte big-endian ``end_pos`` (the
  document's log length right after the commit — the truncation
  watermark) and the commit's applied ops as one uncompressed
  packed-npz blob (``codec.packed.write_packed_npz`` — the same format
  the cascade's cold segments use, so WAL replay and segment loads
  share one codec).
- **group commit** — ``GRAFT_WAL_SYNC=batch`` (the default when a WAL
  is armed): appends buffer through the scheduler round's compute,
  then one fsync per document covers every ticket coalesced into its
  commit, and the document's tickets resolve right after its own
  fsync (per-doc files make a cross-doc barrier pure added latency).
  ``commit`` fsyncs inline per commit; ``off`` disables the WAL
  entirely (the durability-tax baseline).
- **replay taxonomy** (:func:`scan`) — a torn FINAL record (truncated
  header, truncated payload, or a checksum mismatch ending exactly at
  EOF: the shapes a crash mid-append leaves behind) is tolerated,
  counted, and truncated away; a checksum mismatch **mid-log** (valid
  bytes continue past the bad record) is real corruption and raises a
  typed :class:`WalError` — never a silent partial replay.
- **truncation** — spill/fold watermarks drop records whose
  ``end_pos`` is at or below the tiered extent (those ops are durable
  in cold segments + manifest), so steady-state WAL size is O(hot
  tail).  Truncation is atomic (tmp + fsync + rename); a crash
  mid-truncate leaves either file, and duplicate replay absorbs
  through the engine's apply dedup.

Recovery: ``restore_tiered`` opens the
durable manifest's checkpoint base + cold segments, then
:func:`replay_into` re-applies the WAL tail through the ordinary apply
path — records fully below the restored extent are skipped, straddling
ones absorb as duplicates — and the recovered document is
serving-ready immediately with its fencing epoch bumped
(:func:`bump_epoch`).  Windows served off the recovered log stay
byte-identical to the untiered ``packed_since_window`` contract.

Crash-point chaos (:func:`maybe_crash`): ``GRAFT_CRASH_POINT=<site>``
arms a deterministic in-process kill at one of the durability
boundaries (``ack-pre-fsync``, ``post-fsync-pre-publish``,
``mid-spill``, ``mid-fold``, ``mid-manifest-write``).  With
``GRAFT_CRASH_EXIT=1`` the process dies hard (``os._exit(137)`` — the
subprocess matrix and the SIGKILL fleet soak); without it a
:class:`CrashPoint` is raised, which the tier-1 harness uses to model
a crash in-process: everything already ``write()``-en survives in the
page cache exactly as it would a process kill, and the test abandons
the wounded engine and recovers from disk.
"""
from __future__ import annotations

import io
import os
import struct
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

MAGIC = b"GRAFTWAL"          # 8 bytes; file format v1 (per-doc)
SHARED_MAGIC = b"GRAFTWLX"   # 8 bytes; shared-stream format v1
_HDR = struct.Struct("<II")  # payload_len, crc32(payload)
_POS = struct.Struct(">Q")   # end_pos, first 8 payload bytes
_DOC = struct.Struct(">H")   # doc-id length, first 2 shared-payload bytes

# a record length beyond this is garbage, not a record (the serving
# layer caps request bodies at 128 MB; columns add < 2x)
MAX_RECORD_BYTES = 1 << 30

# the deterministic kill sites (docs/DURABILITY.md §Crash-point matrix).
# "pre-queue-fsync" fires on the PIPELINED scheduler between a round's
# merge compute (records appended, unsynced) and queueing the round to
# the WAL-sync worker; "mid-bg-fold" fires on the background
# tier-maintenance worker between a spill and its fold/GC pass — both
# prove the two-stage commit pipeline (serve/workers.py) holds the
# zero-acked-loss contract at its new thread boundaries.
CRASH_SITES = ("ack-pre-fsync", "post-fsync-pre-publish", "mid-spill",
               "mid-fold", "mid-manifest-write", "mid-matz-write",
               "pre-queue-fsync", "mid-bg-fold")

# sites that can only fire on the pipelined commit path (GRAFT_PIPELINE
# armed) — the serialized crash matrix legitimately skips them
PIPELINE_ONLY_SITES = ("pre-queue-fsync", "mid-bg-fold")

SYNC_MODES = ("commit", "batch", "off")

# group-commit fan-out backends (serve/workers.py; docs/DURABILITY.md
# §Sync backends): "single" = the serialized one-fsync-at-a-time lane
# (the A/B baseline), "workers" = the portable threaded fan-out,
# "uring" = completion-driven io_uring submission (utils/uring.py),
# "auto" = uring where the kernel supports it, else workers
SYNC_BACKENDS = ("auto", "uring", "workers", "single")


class WalError(Exception):
    """The WAL is corrupt past the tolerated torn tail (a checksum
    mismatch mid-log, an unreadable record payload): recovery must
    fail loudly, never serve a silent partial replay."""


class CrashPoint(BaseException):
    """Raised by :func:`maybe_crash` in in-process chaos mode.
    Deliberately a ``BaseException``: the scheduler's thread-boundary
    ``except Exception`` guards must NOT swallow a simulated crash
    into a clean 500 — the harness wants the process-death shape
    (nothing after the kill site runs)."""

    def __init__(self, site: str):
        super().__init__(f"GRAFT_CRASH_POINT fired at {site!r}")
        self.site = site


def maybe_crash(site: str) -> None:
    """Die here iff ``GRAFT_CRASH_POINT`` names this site.  Hard
    process exit under ``GRAFT_CRASH_EXIT=1`` (the subprocess matrix);
    a :class:`CrashPoint` otherwise (the in-process tier-1 harness)."""
    if os.environ.get("GRAFT_CRASH_POINT") != site:
        return
    if os.environ.get("GRAFT_CRASH_EXIT"):
        os._exit(137)
    raise CrashPoint(site)


def _fsync_dir(path: str) -> None:
    """fsync a directory so freshly created/renamed entries survive a
    POWER loss, not just a process kill (a killed process's dir
    entries live in the kernel either way).  Best-effort: some
    filesystems refuse directory fds."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _encode_payload(p, end_pos: int) -> bytes:
    """One commit's applied ops as the record payload (end_pos +
    uncompressed packed-npz — compression would put zlib on the ack
    path for a few hundred KB of columns)."""
    from .codec import packed as packed_mod
    buf = io.BytesIO()
    buf.write(_POS.pack(end_pos))
    packed_mod.write_packed_npz(
        buf, p, {"num_ops": p.num_ops,
                 "hints_vouched": bool(p.hints_vouched)},
        compress=False)
    return buf.getvalue()


def _decode_payload(payload: bytes) -> Tuple[int, Any]:
    """Inverse of :func:`_encode_payload` → ``(end_pos, PackedOps)``.
    The crc already vouched for the bytes, so a decode failure here is
    a WAL bug or in-flight tampering — still a typed error."""
    from .codec import packed as packed_mod
    from .core.errors import CheckpointError
    end_pos = _POS.unpack_from(payload)[0]
    try:
        p, _ = packed_mod.load_packed_npz(io.BytesIO(payload[_POS.size:]))
    except CheckpointError as e:
        raise WalError(f"crc-valid WAL record failed to decode: {e}") \
            from e
    return end_pos, p


def _encode_shared_payload(doc_id: str, p, end_pos: int) -> bytes:
    """One commit's applied ops as a SHARED-stream record payload:
    ``u16 doc_id_len | doc_id utf8 | u64 end_pos | packed npz`` — the
    doc id rides the record header so one file can carry every
    document's group commits (docs/DURABILITY.md §Shared WAL)."""
    from .codec import packed as packed_mod
    did = doc_id.encode()
    if len(did) > 0xFFFF:
        raise ValueError(f"doc id too long for the WAL header: "
                         f"{doc_id[:64]!r}…")
    buf = io.BytesIO()
    buf.write(_DOC.pack(len(did)))
    buf.write(did)
    buf.write(_POS.pack(end_pos))
    packed_mod.write_packed_npz(
        buf, p, {"num_ops": p.num_ops,
                 "hints_vouched": bool(p.hints_vouched)},
        compress=False)
    return buf.getvalue()


def _shared_header(payload: bytes) -> Tuple[str, int]:
    """Decode ``(doc_id, end_pos)`` from a shared payload without
    touching the npz blob (the scan/truncation path)."""
    dlen = _DOC.unpack_from(payload)[0]
    hdr_end = _DOC.size + dlen
    if len(payload) < hdr_end + _POS.size:
        raise ValueError("shared payload shorter than its header")
    doc_id = payload[_DOC.size:hdr_end].decode()
    return doc_id, _POS.unpack_from(payload, hdr_end)[0]


def _decode_shared_payload(payload: bytes) -> Tuple[str, int, Any]:
    """Inverse of :func:`_encode_shared_payload` →
    ``(doc_id, end_pos, PackedOps)``."""
    from .codec import packed as packed_mod
    from .core.errors import CheckpointError
    doc_id, end_pos = _shared_header(payload)
    blob_off = _DOC.size + len(doc_id.encode()) + _POS.size
    try:
        p, _ = packed_mod.load_packed_npz(io.BytesIO(payload[blob_off:]))
    except CheckpointError as e:
        raise WalError(f"crc-valid shared WAL record failed to "
                       f"decode: {e}") from e
    return doc_id, end_pos, p


def encode_record(p, end_pos: int) -> bytes:
    """One commit's full per-doc WAL record (header + payload), ready
    for :meth:`Wal.append_encoded`.  The pipelined scheduler encodes
    during a round's compute (the CPU half, safe to discard on a
    shed) and lands the bytes at the round barrier, strictly after
    the previous round's fsync resolved — so a failed group fsync can
    never leave a later round's already-appended record describing
    ops the shed rollback destroyed."""
    payload = _encode_payload(p, end_pos)
    return _HDR.pack(len(payload),
                     zlib.crc32(payload) & 0xFFFFFFFF) + payload


def encode_shared_record(doc_id: str, p, end_pos: int) -> bytes:
    """Shared-stream twin of :func:`encode_record`."""
    payload = _encode_shared_payload(doc_id, p, end_pos)
    return _HDR.pack(len(payload),
                     zlib.crc32(payload) & 0xFFFFFFFF) + payload


def _scan_raw(path: str, magic: bytes
              ) -> Tuple[List[Tuple[int, bytes]], int, int]:
    """Shared record-framing scan: ``(records, torn_dropped,
    good_bytes)`` with each record ``(offset, payload)``.  The
    corruption taxonomy from the module docstring — torn tail
    tolerated and counted, mid-log corruption a typed
    :class:`WalError`.  A missing file is an empty log."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return [], 0, 0
    if not data:
        return [], 0, 0
    if data[:len(magic)] != magic:
        raise WalError(f"WAL {path!r}: bad magic "
                       f"{data[:len(magic)]!r}")
    records: List[Tuple[int, bytes]] = []
    off = len(magic)
    n = len(data)
    while off < n:
        if n - off < _HDR.size:
            return records, 1, off           # torn header at EOF
        ln, crc = _HDR.unpack_from(data, off)
        end = off + _HDR.size + ln
        if ln < _POS.size or ln > MAX_RECORD_BYTES or end > n:
            # impossible length or truncated payload: only legal as
            # the torn final record — a crash mid-append
            return records, 1, off
        payload = data[off + _HDR.size:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            if end == n:
                return records, 1, off       # torn tail: partial write
            raise WalError(
                f"WAL {path!r}: checksum mismatch at offset {off} "
                f"with {n - end} valid bytes beyond it — mid-log "
                f"corruption, refusing a partial replay")
        records.append((off, payload))
        off = end
    return records, 0, off


def scan(path: str) -> Tuple[List[Tuple[int, int, bytes]], int, int]:
    """Parse a per-doc WAL file into ``(records, torn_dropped,
    good_bytes)`` without decoding payloads: each record is
    ``(offset, end_pos, payload)``."""
    raw, torn, good = _scan_raw(path, MAGIC)
    return [(off, _POS.unpack_from(payload)[0], payload)
            for off, payload in raw], torn, good


def _verify(path: str, magic: bytes,
            chunk: int = 1 << 20) -> Dict:
    """Shared body of ``Wal.verify``/``SharedWal.verify``: a STREAMING
    framing + crc32 walk — ``scan``'s corruption taxonomy exactly
    (torn tail counted, mid-log damage reported — never raised: the
    scrub lane surfaces it via prom counters + a flight dump, it must
    not kill maintenance) but O(chunk) memory, never a materialized
    payload list (the sweep runs on a cadence over possibly-huge
    streams)."""
    out = {"records": 0, "torn_tail": 0, "mid_log": 0, "error": None}
    try:
        f = open(path, "rb")
    except FileNotFoundError:
        return out
    with f:
        size = os.fstat(f.fileno()).st_size
        head = f.read(len(magic))
        if not head:
            return out
        if head != magic:
            out["mid_log"] = 1
            out["error"] = f"WAL {path!r}: bad magic {head!r}"
            return out
        off = len(magic)
        while off < size:
            hdr = f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                out["torn_tail"] = 1          # torn header at EOF
                return out
            ln, want = _HDR.unpack(hdr)
            end = off + _HDR.size + ln
            if ln < _POS.size or ln > MAX_RECORD_BYTES or end > size:
                # impossible length or truncated payload: only legal
                # as the torn final record (same rule as _scan_raw)
                out["torn_tail"] = 1
                return out
            crc = 0
            left = ln
            while left > 0:
                piece = f.read(min(chunk, left))
                if not piece:
                    out["torn_tail"] = 1
                    return out
                crc = zlib.crc32(piece, crc)
                left -= len(piece)
            if crc & 0xFFFFFFFF != want:
                if end == size:
                    out["torn_tail"] = 1      # partial final write
                else:
                    out["mid_log"] = 1
                    out["error"] = (
                        f"WAL {path!r}: checksum mismatch at offset "
                        f"{off} with {size - end} valid bytes beyond "
                        f"it — mid-log corruption")
                return out
            out["records"] += 1
            off = end
    return out


def scan_shared(path: str
                ) -> Tuple[List[Tuple[int, str, int, bytes]], int, int]:
    """Parse a shared-stream WAL into ``(records, torn_dropped,
    good_bytes)``: each record is ``(offset, doc_id, end_pos,
    payload)`` with the doc id decoded from the record header and
    ``payload`` still carrying the full shared framing (feed it to
    :func:`_decode_shared_payload` for the columns)."""
    raw, torn, good = _scan_raw(path, SHARED_MAGIC)
    out: List[Tuple[int, str, int, bytes]] = []
    for off, payload in raw:
        try:
            doc_id, end_pos = _shared_header(payload)
        except (struct.error, UnicodeDecodeError, ValueError) as e:
            raise WalError(
                f"shared WAL {path!r}: crc-valid record at offset "
                f"{off} has an unreadable doc header: {e}") from e
        out.append((off, doc_id, end_pos, payload))
    return out, torn, good


class Wal:
    """One document's write-ahead log.  Appends and fsyncs come from
    the scheduler thread; truncation may come from the anti-entropy
    thread (watermark GC) — a lock serializes the file handle.

    NOTE: :class:`SharedWal` carries the SAME append/sync/repair
    error-path contract (failed-append repair to the last record
    boundary, failed-fsync drop of the whole unsynced tail) over its
    own framing — a semantic fix here almost certainly applies there
    too; the crash matrix runs both."""

    def __init__(self, path: str):
        self.path = path
        self._mu = threading.Lock()
        self._f: Optional[Any] = None
        # telemetry (crdt_wal_* prom families; docs/DURABILITY.md)
        self.appends = 0
        self.appended_bytes = 0
        self.fsyncs = 0
        self.truncations = 0
        self.errors = 0
        self.repairs = 0
        self.replay_records = 0
        self.replay_ops = 0
        self.replay_skipped = 0
        self.torn_dropped = 0
        self._fsync_hist = None
        self._size = 0          # last good RECORD boundary
        self._synced_size = 0   # last fsync-durable boundary
        self._opened_once = False
        self._dirty = False     # a failed write left untracked bytes

    def _histogram(self):
        if self._fsync_hist is None:
            from .serve.metrics import LATENCY_BOUNDS_MS, Histogram
            self._fsync_hist = Histogram(LATENCY_BOUNDS_MS)
        return self._fsync_hist

    def _open_locked(self):
        if self._f is None:
            new = not os.path.exists(self.path) \
                or os.path.getsize(self.path) == 0
            self._f = open(self.path, "ab")
            if new:
                self._f.write(MAGIC)
                self._f.flush()
                _fsync_dir(os.path.dirname(self.path))
            self._size = self._f.tell()
            if not self._opened_once:
                # FIRST open: the pre-existing content is the trusted
                # durable baseline (a previous incarnation's log)
                self._synced_size = self._size
                self._opened_once = True
            else:
                # REOPEN after a repair closed the handle: bytes past
                # the last fsync barrier are NOT durable — resetting
                # the barrier here would let a later failed sync keep
                # an unsynced record whose commit was shed (the
                # clean-prefix-of-acked contract)
                self._synced_size = min(self._synced_size, self._size)
        return self._f

    def _repair_locked(self, to_size: int) -> None:
        """A failed write/fsync may have left partial (or
        undurable-garbage) bytes past ``to_size``; truncate them away
        so a later SUCCESSFUL append never buries them mid-log — a
        torn tail must stay a torn tail, not become fatal mid-log
        corruption at recovery.  If the disk refuses even this, stay
        dirty: every append fails until a repair succeeds."""
        try:
            if self._f is not None:
                self._f.close()
        except OSError:
            pass
        self._f = None
        try:
            with open(self.path, "rb+") as f:
                f.truncate(to_size)
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            self._dirty = True
            return
        self._size = to_size
        self._synced_size = min(self._synced_size, to_size)
        self._dirty = False
        self.repairs += 1

    # -- write path (ack-durability: append, then sync, then ack) ---------

    def append(self, p, end_pos: int) -> None:
        """Buffer one commit's applied ops.  Raises ``OSError``
        (ENOSPC/EIO) straight to the scheduler, which ROLLS THE MERGE
        BACK and sheds the commit's tickets as an honest 503 instead
        of crashing (serve/scheduler.py ``_wal_shed``) — the client's
        retry applies for real once the disk recovers.  A failed
        append repairs the file back to the last good record boundary
        so the partial bytes can never be buried mid-log."""
        self.append_encoded(encode_record(p, end_pos))

    def encode(self, p, end_pos: int) -> bytes:
        """Pre-encode one record for the pipelined barrier append
        (module :func:`encode_record`, bound for facade symmetry)."""
        return encode_record(p, end_pos)

    def append_encoded(self, rec: bytes) -> None:
        """Append one pre-encoded record (:func:`encode_record`) —
        same error contract as :meth:`append`."""
        with self._mu:
            if self._dirty:
                self._repair_locked(self._size)
                if self._dirty:
                    self.errors += 1
                    raise OSError(
                        f"WAL {self.path!r} needs repair after a "
                        f"failed write and the disk still refuses")
            try:
                f = self._open_locked()
                f.write(rec)
                f.flush()
            except OSError:
                self.errors += 1
                self._repair_locked(self._size)
                raise
            self.appends += 1
            self.appended_bytes += len(rec)
            self._size += len(rec)

    def sync(self) -> None:
        """fsync everything appended so far — the durability point the
        ack waits on.  One call covers every record buffered since the
        last sync (the group-commit amortization).  On failure the
        unsynced tail is truncated away: its commits are being shed
        and rolled back, and after a writeback error the page cache
        can no longer be trusted to match the platter (the classic
        fsync-error hazard) — dropping the tail keeps the on-disk log
        a clean prefix of what was ever acked."""
        import time
        with self._mu:
            try:
                f = self._open_locked()
                t0 = time.perf_counter()
                os.fsync(f.fileno())
            except OSError:
                self.errors += 1
                self._repair_locked(self._synced_size)
                raise
            self._synced_size = self._size
            self.fsyncs += 1
            self._histogram().observe(
                (time.perf_counter() - t0) * 1e3)

    # -- out-of-band sync (completion-driven lane; serve/workers.py) -------
    #
    # The io_uring backend fsyncs the fd from a ring instead of calling
    # os.fsync inline, so the durability bookkeeping splits in two:
    # sync_begin hands out the fd (flushing userspace buffers so the
    # kernel sees every appended byte), sync_end lands the SAME barrier
    # advance / failure repair :meth:`sync` would have.  Safe because
    # the per-doc pipeline barrier guarantees append and fsync never
    # overlap for one document: between begin and end nothing mutates
    # ``_size`` or reopens the handle, so completing the fsync at
    # ``_synced_size = _size`` is exact.

    def sync_begin(self) -> int:
        """Flush and expose the fd for an externally-driven fsync.
        Same failure contract as :meth:`sync`: an OSError here repairs
        back to the durable barrier and propagates (the commit sheds)."""
        with self._mu:
            try:
                f = self._open_locked()
                f.flush()
                return f.fileno()
            except OSError:
                self.errors += 1
                self._repair_locked(self._synced_size)
                raise

    def sync_end(self, err: int, ms: float) -> None:
        """Land an out-of-band fsync's result: ``err`` is 0 on success
        or a positive errno.  Success advances the durable barrier and
        books the fsync exactly like :meth:`sync`; failure repairs the
        unsynced tail away and raises the OSError the shed path
        expects."""
        with self._mu:
            if err:
                self.errors += 1
                self._repair_locked(self._synced_size)
                raise OSError(err, os.strerror(err))
            self._synced_size = self._size
            self.fsyncs += 1
            self._histogram().observe(ms)

    # -- truncation (spill/fold watermark) ---------------------------------

    def truncate_below(self, pos: int) -> int:
        """Drop records whose ``end_pos`` ≤ ``pos`` (their ops are
        durable in cold segments + manifest).  Atomic rewrite; returns
        the number of records dropped.  A record straddling ``pos``
        stays whole — duplicate replay absorbs."""
        with self._mu:
            if self._f is not None:
                self._f.flush()
            try:
                records, torn, _ = scan(self.path)
            except WalError:
                # a live log should never be corrupt; leave the
                # evidence in place for recovery to report
                self.errors += 1
                return 0
            keep = [r for r in records if r[1] > pos]
            if len(keep) == len(records) and not torn:
                return 0
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(MAGIC)
                for _, end_pos, payload in keep:
                    f.write(_HDR.pack(
                        len(payload),
                        zlib.crc32(payload) & 0xFFFFFFFF))
                    f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            if self._f is not None:
                self._f.close()
                self._f = None
            os.replace(tmp, self.path)
            _fsync_dir(os.path.dirname(self.path))
            self._size = os.path.getsize(self.path)
            self._synced_size = self._size
            self._dirty = False
            self.truncations += 1
            return len(records) - len(keep)

    # -- recovery ----------------------------------------------------------

    def replay_into(self, tree, chunk_ops: int = 1 << 17) -> Dict:
        """Re-apply the WAL tail into ``tree`` (a just-restored
        checkpoint base + cold segments, or a fresh tree) through the
        ordinary apply path, so dedup/ordering semantics are exactly
        the serving engine's.  Records fully at or below the restored
        extent are skipped (their ops are already in the tiers);
        straddling records re-apply whole and the overlap absorbs.
        Raises :class:`WalError` on mid-log corruption or a record
        that fails to re-apply (an acked write that cannot be restored
        is exactly the loss this log exists to prevent)."""
        from .core.errors import CRDTError
        base_len = tree.log_length
        records, torn, _ = scan(self.path)
        self.torn_dropped += torn
        applied = 0
        for _, end_pos, payload in records:
            if end_pos <= base_len:
                self.replay_skipped += 1
                continue
            _, p = _decode_payload(payload)
            try:
                tree.apply_packed_chunked(p, chunk_ops)
            except CRDTError as e:
                raise WalError(
                    f"WAL record (end_pos {end_pos}) failed to "
                    f"re-apply during recovery: {e!r}") from e
            self.replay_records += 1
            self.replay_ops += p.num_ops
            applied += int(tree.last_applied_mask.sum()) \
                if tree.last_applied_mask is not None else 0
        if torn:
            # drop the torn tail on disk too, so the next append
            # starts at a clean record boundary
            self.truncate_below(-1)
        return {"records": self.replay_records,
                "ops": self.replay_ops,
                "applied": applied,
                "skipped": self.replay_skipped,
                "torn_dropped": torn,
                "base_len": base_len,
                "log_len": tree.log_length}

    # -- scrub (docs/DURABILITY.md §Scrub & repair) --------------------------

    def verify(self) -> Dict:
        """Walk the on-disk stream's record framing + crc32 without
        decoding payloads — the maintenance lane's WAL sweep, so
        mid-log damage surfaces on the scrub cadence instead of first
        being discovered at recovery.  Returns ``{"records",
        "torn_tail", "mid_log", "error"}``; a torn TAIL is the benign
        class (a crash leftover recovery drops, or an append racing
        the sweep), mid-log damage is the typed-:class:`WalError`
        class recovery would refuse on."""
        with self._mu:
            if self._f is not None:
                try:
                    self._f.flush()
                except OSError:
                    pass
        return _verify(self.path, MAGIC)

    # -- lifecycle / telemetry ---------------------------------------------

    def size_bytes(self) -> int:
        with self._mu:
            if self._f is not None:
                return self._size
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def close(self) -> None:
        with self._mu:
            if self._f is not None:
                try:
                    self._f.flush()
                    self._f.close()
                except OSError:
                    self.errors += 1
                self._f = None

    def telemetry(self) -> Dict:
        """JSON-safe counter/gauge snapshot (per-doc ``/metrics`` key
        + the ``crdt_wal_*`` prom families)."""
        with self._mu:
            hist = None if self._fsync_hist is None \
                else self._fsync_hist.export()
        return {
            "appends": self.appends,
            "appended_bytes": self.appended_bytes,
            "fsyncs": self.fsyncs,
            "fsync_ms": hist,
            "truncations": self.truncations,
            "errors": self.errors,
            "repairs": self.repairs,
            "replay_records": self.replay_records,
            "replay_ops": self.replay_ops,
            "replay_skipped": self.replay_skipped,
            "torn_dropped": self.torn_dropped,
            "size_bytes": self.size_bytes(),
        }


class SharedWal:
    """ONE write-ahead stream for a whole engine's documents
    (``GRAFT_WAL_SHARED=1``; docs/DURABILITY.md §Shared WAL).

    A many-doc durable fleet under per-doc WALs burns one fsync stream
    per document per scheduler round; here every document's commit
    records append to a single file (doc id in the record header) and
    ONE fsync per round makes all of them durable — the scheduler
    resolves every covered document's tickets right after that single
    barrier, so fsyncs/round is O(1) instead of O(docs touched) at
    exactly the same durability point (fsync-before-ack).

    Per-doc truncation becomes per-doc DURABLE MARKS: a document's
    spill/fold advances its mark, and compaction rewrites the stream
    dropping records every owner's tiers already cover (atomic
    tmp+fsync+rename, same recipe as ``Wal.truncate_below``), so
    steady-state size is O(sum of hot tails).

    Thread model: appends/fsyncs from the scheduler thread, marks from
    scheduler or anti-entropy threads — one lock serializes the file,
    exactly like :class:`Wal`.  The append/sync/repair error paths
    deliberately mirror :class:`Wal`'s clause for clause (same
    fsyncgate contract, different framing) — keep them in sync; the
    crash matrix runs both."""

    def __init__(self, path: str):
        self.path = path
        self._mu = threading.Lock()
        self._f: Optional[Any] = None
        self._marks: Dict[str, int] = {}
        # telemetry (crdt_wal_shared_* prom families)
        self.appends = 0
        self.appended_bytes = 0
        self.fsyncs = 0
        self.sync_rounds = 0
        self.compactions = 0
        self.errors = 0
        self.repairs = 0
        self.torn_dropped = 0
        self._covered_hist = None
        self._fsync_hist = None
        self._size = 0
        self._synced_size = 0
        self._last_compact_size = 0
        self._opened_once = False
        self._dirty = False
        # pipelined mode (serve/workers.py): a due compaction is
        # HANDED to the maintenance worker instead of rewriting the
        # stream on the scheduler thread mid-round
        self._compact_cb: Optional[Any] = None
        self._compact_queued = False

    def _histogram(self, which: str):
        from .serve.metrics import (LATENCY_BOUNDS_MS, WIDTH_BOUNDS,
                                    Histogram)
        if which == "fsync":
            if self._fsync_hist is None:
                self._fsync_hist = Histogram(LATENCY_BOUNDS_MS)
            return self._fsync_hist
        if self._covered_hist is None:
            self._covered_hist = Histogram(WIDTH_BOUNDS)
        return self._covered_hist

    def _open_locked(self):
        if self._f is None:
            new = not os.path.exists(self.path) \
                or os.path.getsize(self.path) == 0
            self._f = open(self.path, "ab")
            if new:
                self._f.write(SHARED_MAGIC)
                self._f.flush()
                _fsync_dir(os.path.dirname(self.path))
            self._size = self._f.tell()
            if not self._opened_once:
                # first open trusts pre-existing content; a REOPEN
                # after a repair must NOT promote the unsynced tail
                # to durable (same contract as Wal._open_locked)
                self._synced_size = self._size
                self._opened_once = True
            else:
                self._synced_size = min(self._synced_size, self._size)
        return self._f

    def _repair_locked(self, to_size: int) -> None:
        """Same contract as ``Wal._repair_locked``: a failed
        write/fsync must never leave partial bytes that a later
        success would bury mid-log."""
        try:
            if self._f is not None:
                self._f.close()
        except OSError:
            pass
        self._f = None
        try:
            with open(self.path, "rb+") as f:
                f.truncate(to_size)
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            self._dirty = True
            return
        self._size = to_size
        self._synced_size = min(self._synced_size, to_size)
        self._dirty = False
        self.repairs += 1

    # -- write path -------------------------------------------------------

    def append(self, doc_id: str, p, end_pos: int) -> None:
        """Buffer one document's commit record.  OSError semantics are
        the per-doc WAL's: raised to the scheduler, which rolls back
        and sheds THAT commit (other documents' already-appended
        records this round stay intact — the repair truncates only
        the failed append's partial bytes)."""
        self.append_encoded(encode_shared_record(doc_id, p, end_pos))

    def append_encoded(self, rec: bytes) -> None:
        """Append one pre-encoded shared record
        (:func:`encode_shared_record`) — same error contract as
        :meth:`append`."""
        with self._mu:
            if self._dirty:
                self._repair_locked(self._size)
                if self._dirty:
                    self.errors += 1
                    raise OSError(
                        f"shared WAL {self.path!r} needs repair after "
                        f"a failed write and the disk still refuses")
            try:
                f = self._open_locked()
                f.write(rec)
                f.flush()
            except OSError:
                self.errors += 1
                self._repair_locked(self._size)
                raise
            self.appends += 1
            self.appended_bytes += len(rec)
            self._size += len(rec)

    def sync(self, covered_docs: int = 1) -> None:
        """THE round barrier: one fsync makes every record appended
        since the last sync durable, across all documents
        (``covered_docs`` feeds the amortization histogram).  Failure
        drops the whole unsynced tail — every covered commit is being
        shed and rolled back, and a post-error page cache is
        untrustworthy (same fsyncgate rule as the per-doc WAL)."""
        import time
        with self._mu:
            try:
                f = self._open_locked()
                t0 = time.perf_counter()
                os.fsync(f.fileno())
            except OSError:
                self.errors += 1
                self._repair_locked(self._synced_size)
                raise
            self._synced_size = self._size
            self.fsyncs += 1
            self.sync_rounds += 1
            self._histogram("fsync").observe(
                (time.perf_counter() - t0) * 1e3)
            self._histogram("covered").observe(max(1, covered_docs))

    # -- per-doc durable marks + compaction -------------------------------

    def mark_durable(self, doc_id: str, pos: int) -> int:
        """Document ``doc_id``'s tiers now cover rows below ``pos``:
        its records at or below are dead weight.  The mark itself is
        O(1); the stream compacts (atomic rewrite dropping every
        doc's covered records) only once it has grown past
        max(1 MB, 2× its size after the last compaction) — a full
        rewrite per mark would re-read and re-CRC every document's
        records on the scheduler thread at every spill (per-doc mode
        paid O(own file); amortized doubling keeps the shared cost
        O(1) per appended byte).  Returns records dropped (0 when
        compaction deferred)."""
        with self._mu:
            self._marks[doc_id] = max(
                self._marks.get(doc_id, 0), int(pos))
            if self._f is None and self._size == 0:
                # recovery-time marks arrive before the first append
                # opens the file: size up the on-disk stream or a big
                # dead log would defer compaction forever
                try:
                    self._size = os.path.getsize(self.path)
                except OSError:
                    pass
            if self._size < max(1 << 20, 2 * self._last_compact_size):
                return 0
            if self._compact_cb is None:
                return self._compact_locked()
            if self._compact_queued:
                return 0
            self._compact_queued = True
            cb = self._compact_cb
        # deferred: the rewrite (scan + re-CRC of every live record)
        # runs on the maintenance worker, off the thread that crossed
        # the threshold.  The cb returns False when the worker's
        # bounded queue refused — the latch must reset either way or
        # a single full-queue moment would disable compaction forever
        try:
            ok = bool(cb())
        except Exception:   # noqa: BLE001 — worker-queue boundary
            ok = False
        if not ok:
            with self._mu:
                self._compact_queued = False
        return 0

    def set_compact_cb(self, cb) -> None:
        """Defer threshold-triggered compactions to ``cb`` (the
        maintenance worker's enqueue, serve/workers.py) instead of
        rewriting the stream inline on whatever thread crossed the
        threshold."""
        with self._mu:
            self._compact_cb = cb

    def compact(self) -> int:
        """Force a stream compaction now (tests / shutdown hygiene)."""
        with self._mu:
            return self._compact_locked()

    def _compact_locked(self) -> int:
        self._compact_queued = False
        if self._f is not None:
            self._f.flush()
        try:
            records, torn, _ = scan_shared(self.path)
        except WalError:
            self.errors += 1
            return 0
        keep = [r for r in records
                if r[2] > self._marks.get(r[1], -1)]
        if len(keep) == len(records) and not torn:
            self._last_compact_size = self._size
            return 0
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(SHARED_MAGIC)
            for _, _, _, payload in keep:
                f.write(_HDR.pack(
                    len(payload),
                    zlib.crc32(payload) & 0xFFFFFFFF))
                f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        if self._f is not None:
            self._f.close()
            self._f = None
        os.replace(tmp, self.path)
        _fsync_dir(os.path.dirname(self.path))
        self._size = os.path.getsize(self.path)
        self._synced_size = self._size
        self._last_compact_size = self._size
        self._dirty = False
        self.compactions += 1
        return len(records) - len(keep)

    # -- recovery ----------------------------------------------------------

    def recover_records(self) -> Dict[str, List[Tuple[int, bytes]]]:
        """One startup scan partitioning the stream per document:
        ``{doc_id: [(end_pos, payload), ...]}`` in append order.  A
        torn final record is dropped (on disk too, so the next append
        starts at a clean boundary) and counted; mid-log corruption
        raises :class:`WalError`."""
        with self._mu:
            records, torn, good = scan_shared(self.path)
            if torn:
                self.torn_dropped += torn
                try:
                    with open(self.path, "rb+") as f:
                        f.truncate(good)
                        f.flush()
                        os.fsync(f.fileno())
                except OSError:
                    self.errors += 1
            # seed the size bookkeeping from the scan so recovery-time
            # durable marks can trigger compaction of a big dead
            # stream (the file hasn't been opened for append yet)
            if good:
                self._size = good
                self._synced_size = good
                self._opened_once = True
            out: Dict[str, List[Tuple[int, bytes]]] = {}
            for _, doc_id, end_pos, payload in records:
                out.setdefault(doc_id, []).append((end_pos, payload))
            return out

    # -- scrub (same contract as Wal.verify) -------------------------------

    def verify(self) -> Dict:
        """Framing + crc32 walk of the shared stream (every document's
        records in one pass — the per-doc facades all delegate
        here)."""
        with self._mu:
            if self._f is not None:
                try:
                    self._f.flush()
                except OSError:
                    pass
        return _verify(self.path, SHARED_MAGIC)

    # -- lifecycle / telemetry ---------------------------------------------

    def size_bytes(self) -> int:
        with self._mu:
            if self._f is not None:
                return self._size
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def close(self) -> None:
        with self._mu:
            if self._f is not None:
                try:
                    self._f.flush()
                    self._f.close()
                except OSError:
                    self.errors += 1
                self._f = None

    def telemetry(self) -> Dict:
        with self._mu:
            fh = None if self._fsync_hist is None \
                else self._fsync_hist.export()
            ch = None if self._covered_hist is None \
                else self._covered_hist.export()
        return {
            "appends": self.appends,
            "appended_bytes": self.appended_bytes,
            "fsyncs": self.fsyncs,
            "sync_rounds": self.sync_rounds,
            "fsync_ms": fh,
            "covered_docs": ch,
            "compactions": self.compactions,
            "errors": self.errors,
            "repairs": self.repairs,
            "torn_dropped": self.torn_dropped,
            "size_bytes": self.size_bytes(),
            "docs_marked": len(self._marks),
        }


class DocWalView:
    """One document's facade over the engine's :class:`SharedWal` —
    the surface the scheduler and ``ServedDoc`` already speak
    (``append``/``sync``/``truncate_below``/``replay_into``/
    ``telemetry``), so shared mode slots in without forking the
    commit path.  ``sync`` fsyncs the SHARED stream (commit-mode
    callers); in batch mode the scheduler skips the per-doc facade
    and drives one ``SharedWal.sync`` per round directly."""

    def __init__(self, shared: SharedWal, doc_id: str,
                 records: Optional[List[Tuple[int, bytes]]] = None):
        self.shared = shared
        self.doc_id = doc_id
        self._records = records or []
        # per-doc telemetry (the shared stream's counters aggregate
        # every document; these keep /metrics per-doc keys honest)
        self.appends = 0
        self.appended_bytes = 0
        self.truncations = 0
        self.replay_records = 0
        self.replay_ops = 0
        self.replay_skipped = 0
        self.torn_dropped = 0

    def append(self, p, end_pos: int) -> None:
        # appends come from the single scheduler thread, so the
        # before/after delta attributes this record's bytes to THIS
        # doc without new plumbing in the shared append path
        b0 = self.shared.appended_bytes
        self.shared.append(self.doc_id, p, end_pos)
        self.appends += 1
        self.appended_bytes += self.shared.appended_bytes - b0

    def encode(self, p, end_pos: int) -> bytes:
        """Pre-encode one record for the pipelined barrier append
        (the per-doc facade's twin of :func:`encode_record`)."""
        return encode_shared_record(self.doc_id, p, end_pos)

    def append_encoded(self, rec: bytes) -> None:
        b0 = self.shared.appended_bytes
        self.shared.append_encoded(rec)
        self.appends += 1
        self.appended_bytes += self.shared.appended_bytes - b0

    def sync(self) -> None:
        self.shared.sync(covered_docs=1)

    def truncate_below(self, pos: int) -> int:
        dropped = self.shared.mark_durable(self.doc_id, pos)
        self.truncations += 1
        return dropped

    def replay_into(self, tree, chunk_ops: int = 1 << 17) -> Dict:
        """Re-apply this document's pre-scanned shared records (same
        semantics as ``Wal.replay_into``: records at or below the
        restored extent skip, overlaps dup-absorb, a record that
        fails to re-apply is typed acked loss)."""
        from .core.errors import CRDTError
        base_len = tree.log_length
        applied = 0
        for end_pos, payload in self._records:
            if end_pos <= base_len:
                self.replay_skipped += 1
                continue
            _, _, p = _decode_shared_payload(payload)
            try:
                tree.apply_packed_chunked(p, chunk_ops)
            except CRDTError as e:
                raise WalError(
                    f"shared WAL record for {self.doc_id!r} "
                    f"(end_pos {end_pos}) failed to re-apply during "
                    f"recovery: {e!r}") from e
            self.replay_records += 1
            self.replay_ops += p.num_ops
            applied += int(tree.last_applied_mask.sum()) \
                if tree.last_applied_mask is not None else 0
        self._records = []      # replayed once; don't pin the payloads
        return {"records": self.replay_records,
                "ops": self.replay_ops,
                "applied": applied,
                "skipped": self.replay_skipped,
                "torn_dropped": 0,
                "base_len": base_len,
                "log_len": tree.log_length}

    def size_bytes(self) -> int:
        return self.shared.size_bytes()

    def verify(self) -> Dict:
        """The scrub sweep through the facade verifies the WHOLE
        shared stream (this document's records have no standalone
        framing of their own)."""
        return self.shared.verify()

    def close(self) -> None:
        pass                    # the engine owns the shared stream

    def telemetry(self) -> Dict:
        """Per-doc keys (`appends`/`appended_bytes`/`truncations`/
        `replay_*`) are genuinely this document's; `fsyncs`/`fsync_ms`/
        `errors`/`repairs`/`size_bytes` describe the WHOLE shared
        stream (marked by `shared: true`) — the prom surface renders
        those once under `crdt_wal_shared_*` instead of per doc."""
        sh = self.shared.telemetry()
        return {
            "shared": True,
            "appends": self.appends,
            "appended_bytes": self.appended_bytes,
            "fsyncs": sh["fsyncs"],
            "fsync_ms": sh["fsync_ms"],
            "truncations": self.truncations,
            "errors": sh["errors"],
            "repairs": sh["repairs"],
            "replay_records": self.replay_records,
            "replay_ops": self.replay_ops,
            "replay_skipped": self.replay_skipped,
            "torn_dropped": self.torn_dropped,
            "size_bytes": sh["size_bytes"],
        }


# -- fencing epoch ---------------------------------------------------------


def bump_epoch(dir: str) -> int:
    """Read, increment, and persist the document's fencing epoch
    (``epoch`` file next to the WAL) — every recovery-to-serving is a
    new incarnation, observable in ``/metrics`` and the flight
    stream.  Returns the NEW epoch (1 for a fresh document)."""
    path = os.path.join(dir, "epoch")
    try:
        with open(path) as f:
            prev = int(f.read().strip() or 0)
    except (OSError, ValueError):
        prev = 0
    epoch = prev + 1
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(epoch))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(dir)
    return epoch


def sync_mode_from_env(default: str = "batch") -> str:
    """The ``GRAFT_WAL_SYNC`` knob, validated."""
    mode = os.environ.get("GRAFT_WAL_SYNC", default).strip() or default
    return mode if mode in SYNC_MODES else default


def sync_backend_from_env(default: str = "auto") -> str:
    """The ``GRAFT_WAL_SYNC_BACKEND`` knob, validated (``SYNC_BACKENDS``;
    resolution of ``auto`` — and of an explicit ``uring`` the kernel
    cannot honor — happens in serve/workers.py where the fallback is
    counted, never silent)."""
    backend = os.environ.get("GRAFT_WAL_SYNC_BACKEND",
                             default).strip() or default
    return backend if backend in SYNC_BACKENDS else default
