"""Minimal ctypes ``io_uring`` binding for the completion-driven WAL
sync lane (serve/workers.py; docs/DURABILITY.md §Sync backends).

The group-commit fan-out only needs TWO operations from the kernel
interface: ``IORING_OP_FSYNC`` (one per per-doc WAL file, many in
flight from one ring, completions reaped as EACH file's durability
lands) and ``IORING_OP_POLL_ADD`` on an eventfd (the cross-thread
wakeup: the scheduler's submit path writes the eventfd, which posts a
CQE and unblocks the ring owner's ``io_uring_enter`` wait).  So this
module binds the three raw syscalls directly instead of shipping (or
requiring) liburing:

- ``io_uring_setup(2)``   — create the ring, mmap SQ/CQ/SQE regions
- ``io_uring_enter(2)``   — submit SQEs / wait for CQEs
- (``io_uring_register`` is not needed for this workload)

Threading contract: exactly ONE thread (the ring owner — the WAL-sync
worker) calls :meth:`FsyncRing.submit_fsync` and
:meth:`FsyncRing.wait_completions`; any thread may call
:meth:`FsyncRing.wake`.  Without ``IORING_SETUP_SQPOLL`` the kernel
consumes SQEs synchronously inside ``io_uring_enter``, and CQEs are
only read after an ``enter`` returned — every ring-memory handoff is
therefore ordered by a syscall (a full barrier), so no userspace
atomics are required.

:func:`available` probes once per process whether the running kernel
(and seccomp policy — containers often filter the syscall) actually
supports io_uring; the sync-backend auto-detect keys off it and falls
back to the portable threaded lane (``GRAFT_WAL_SYNC_BACKEND``,
docs/DURABILITY.md).
"""
from __future__ import annotations

import ctypes
import mmap
import os
import platform
import struct
import threading
from typing import List, Optional, Tuple

# syscall numbers are identical on x86_64 and aarch64 (io_uring
# landed after the unified syscall table)
_NR_IO_URING_SETUP = 425
_NR_IO_URING_ENTER = 426

_IORING_OFF_SQ_RING = 0
_IORING_OFF_CQ_RING = 0x8000000
_IORING_OFF_SQES = 0x10000000

_IORING_ENTER_GETEVENTS = 1
_IORING_FEAT_SINGLE_MMAP = 1 << 0

_IORING_OP_FSYNC = 3
_IORING_OP_POLL_ADD = 6
_POLLIN = 0x0001

# struct io_uring_params offsets (fixed ABI; 120 bytes total)
_PARAMS_SZ = 120
_P_SQ_ENTRIES = 0
_P_CQ_ENTRIES = 4
_P_FEATURES = 20
_SQ_OFF = 40    # struct io_sqring_offsets (u32 fields)
_CQ_OFF = 80    # struct io_cqring_offsets (u32 fields)

_SQE_SZ = 64
_CQE_SZ = 16

# poll-wakeup user_data sentinel: real fsync tokens are small positive
# ints minted by the worker, so a high bit can never collide
WAKE_TOKEN = (1 << 63) - 1


class UringUnavailable(OSError):
    """The running kernel (or its seccomp policy) refuses io_uring."""


_libc = None
_libc_mu = threading.Lock()


def _get_libc():
    global _libc
    with _libc_mu:
        if _libc is None:
            _libc = ctypes.CDLL(None, use_errno=True)
        return _libc


def _syscall(nr: int, *args) -> int:
    libc = _get_libc()
    res = libc.syscall(ctypes.c_long(nr), *args)
    if res < 0:
        err = ctypes.get_errno()
        raise OSError(err, os.strerror(err))
    return res


def _u32(buf, off: int) -> int:
    return struct.unpack_from("<I", buf, off)[0]


class FsyncRing:
    """One io_uring instance specialized for fan-out fsync + eventfd
    wakeup (module docstring for the threading contract)."""

    def __init__(self, entries: int = 256):
        if platform.system() != "Linux":
            raise UringUnavailable(0, "io_uring is Linux-only")
        params = bytearray(_PARAMS_SZ)
        pbuf = (ctypes.c_char * _PARAMS_SZ).from_buffer(params)
        try:
            self._fd = _syscall(_NR_IO_URING_SETUP,
                                ctypes.c_uint(entries),
                                ctypes.byref(pbuf))
        except OSError as e:
            raise UringUnavailable(e.errno or 0, str(e)) from e
        self._closed = False
        self._sq_entries = _u32(params, _P_SQ_ENTRIES)
        self._cq_entries = _u32(params, _P_CQ_ENTRIES)
        features = _u32(params, _P_FEATURES)
        sq_head_off = _u32(params, _SQ_OFF + 0)
        sq_tail_off = _u32(params, _SQ_OFF + 4)
        sq_mask_off = _u32(params, _SQ_OFF + 8)
        sq_array_off = _u32(params, _SQ_OFF + 24)
        cq_head_off = _u32(params, _CQ_OFF + 0)
        cq_tail_off = _u32(params, _CQ_OFF + 4)
        cq_mask_off = _u32(params, _CQ_OFF + 8)
        cq_cqes_off = _u32(params, _CQ_OFF + 20)
        sq_sz = sq_array_off + self._sq_entries * 4
        cq_sz = cq_cqes_off + self._cq_entries * _CQE_SZ
        try:
            if features & _IORING_FEAT_SINGLE_MMAP:
                ring_sz = max(sq_sz, cq_sz)
                self._sq_mm = mmap.mmap(
                    self._fd, ring_sz, flags=mmap.MAP_SHARED,
                    prot=mmap.PROT_READ | mmap.PROT_WRITE,
                    offset=_IORING_OFF_SQ_RING)
                self._cq_mm = self._sq_mm
            else:
                self._sq_mm = mmap.mmap(
                    self._fd, sq_sz, flags=mmap.MAP_SHARED,
                    prot=mmap.PROT_READ | mmap.PROT_WRITE,
                    offset=_IORING_OFF_SQ_RING)
                self._cq_mm = mmap.mmap(
                    self._fd, cq_sz, flags=mmap.MAP_SHARED,
                    prot=mmap.PROT_READ | mmap.PROT_WRITE,
                    offset=_IORING_OFF_CQ_RING)
            self._sqes = mmap.mmap(
                self._fd, self._sq_entries * _SQE_SZ,
                flags=mmap.MAP_SHARED,
                prot=mmap.PROT_READ | mmap.PROT_WRITE,
                offset=_IORING_OFF_SQES)
        except OSError as e:
            os.close(self._fd)
            raise UringUnavailable(e.errno or 0, str(e)) from e
        self._sq_head_off = sq_head_off
        self._sq_tail_off = sq_tail_off
        self._sq_mask = _u32(self._sq_mm, sq_mask_off)
        self._sq_array_off = sq_array_off
        self._cq_head_off = cq_head_off
        self._cq_tail_off = cq_tail_off
        self._cq_mask = _u32(self._cq_mm, cq_mask_off)
        self._cq_cqes_off = cq_cqes_off
        self._sq_tail = _u32(self._sq_mm, sq_tail_off)
        # bound in-ring fsyncs well under the CQ size so completions
        # can never overflow even with the wakeup poll armed
        self.max_inflight = max(1, self._cq_entries // 2 - 2)
        self.inflight = 0            # fsyncs submitted, not yet reaped
        # cross-thread wakeup: submit() (any thread) bumps the eventfd;
        # the armed POLL_ADD posts a CQE that unblocks the owner's wait
        self._efd = os.eventfd(0, os.EFD_CLOEXEC | os.EFD_NONBLOCK)
        self._arm_wakeup()

    # -- SQE plumbing (ring-owner thread only) ----------------------------

    def _push_sqe(self, opcode: int, fd: int, op_flags: int,
                  user_data: int) -> None:
        head = _u32(self._sq_mm, self._sq_head_off)
        if self._sq_tail - head >= self._sq_entries:
            # SQ full (cannot happen at our submit cadence — every
            # push is followed by an enter that consumes it — but a
            # kernel that leaves entries would otherwise wedge us)
            self._enter(0, 1, _IORING_ENTER_GETEVENTS)
        idx = self._sq_tail & self._sq_mask
        sqe = bytearray(_SQE_SZ)
        struct.pack_into("<BBHi", sqe, 0, opcode, 0, 0, fd)
        struct.pack_into("<I", sqe, 28, op_flags)
        struct.pack_into("<Q", sqe, 32, user_data)
        self._sqes[idx * _SQE_SZ:(idx + 1) * _SQE_SZ] = bytes(sqe)
        struct.pack_into("<I", self._sq_mm,
                         self._sq_array_off + idx * 4, idx)
        self._sq_tail += 1
        struct.pack_into("<I", self._sq_mm, self._sq_tail_off,
                         self._sq_tail & 0xFFFFFFFF)
        self._enter(1, 0, 0)

    def _enter(self, to_submit: int, min_complete: int,
               flags: int) -> int:
        while True:
            try:
                return _syscall(
                    _NR_IO_URING_ENTER, ctypes.c_uint(self._fd),
                    ctypes.c_uint(to_submit),
                    ctypes.c_uint(min_complete), ctypes.c_uint(flags),
                    ctypes.c_void_p(0), ctypes.c_size_t(0))
            except OSError as e:
                if e.errno == 4:     # EINTR: retry the wait
                    continue
                raise

    def _arm_wakeup(self) -> None:
        self._push_sqe(_IORING_OP_POLL_ADD, self._efd, _POLLIN,
                       WAKE_TOKEN)

    # -- public API --------------------------------------------------------

    def submit_fsync(self, fd: int, token: int) -> None:
        """Queue one fsync; the completion surfaces from
        :meth:`wait_completions` as ``(token, res)`` with ``res`` 0 on
        success or a negative errno.  Ring-owner thread only."""
        self._push_sqe(_IORING_OP_FSYNC, fd, 0, token)
        self.inflight += 1

    def wake(self) -> None:
        """Unblock a ring owner parked in :meth:`wait_completions`
        (any thread; called by the scheduler-side submit path and by
        stop)."""
        try:
            os.eventfd_write(self._efd, 1)
        except OSError:
            pass                     # closing ring: owner already woke

    def wait_completions(self, block: bool = True
                         ) -> List[Tuple[int, int]]:
        """Reap every posted CQE; when ``block`` and none are posted,
        sleep in ``io_uring_enter`` until a completion OR a wakeup
        lands.  Returns ``[(token, res), ...]`` for fsync completions
        (wakeup CQEs are absorbed and re-armed internally) — possibly
        empty after a pure wakeup.  Ring-owner thread only."""
        out = self._reap()
        if out or not block:
            return out
        self._enter(0, 1, _IORING_ENTER_GETEVENTS)
        return self._reap()

    def _reap(self) -> List[Tuple[int, int]]:
        out: List[Tuple[int, int]] = []
        head = _u32(self._cq_mm, self._cq_head_off)
        while True:
            tail = _u32(self._cq_mm, self._cq_tail_off)
            if head == tail:
                break
            idx = head & self._cq_mask
            off = self._cq_cqes_off + idx * _CQE_SZ
            user_data, res = struct.unpack_from("<Qi", self._cq_mm,
                                                off)
            head += 1
            struct.pack_into("<I", self._cq_mm, self._cq_head_off,
                             head & 0xFFFFFFFF)
            if user_data == WAKE_TOKEN:
                try:
                    os.eventfd_read(self._efd)   # drain the counter
                except (BlockingIOError, OSError):
                    pass
                self._arm_wakeup()
            else:
                self.inflight -= 1
                out.append((user_data, res))
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._sqes.close()
            if self._cq_mm is not self._sq_mm:
                self._cq_mm.close()
            self._sq_mm.close()
        except (BufferError, OSError):
            pass
        os.close(self._fd)
        os.close(self._efd)


_avail: Optional[bool] = None
_avail_mu = threading.Lock()


def available() -> bool:
    """True when this kernel accepts ``io_uring_setup`` AND the ring
    survives a full fsync round-trip (probed once per process: many
    container seccomp policies return EPERM/ENOSYS, and a kernel that
    sets the ring up but cannot complete an fsync must not be trusted
    with the durability path)."""
    global _avail
    with _avail_mu:
        if _avail is not None:
            return _avail
        if not hasattr(os, "eventfd"):
            _avail = False       # wakeup path needs eventfd (py3.10+)
            return _avail
        try:
            ring = FsyncRing(entries=8)
        except (UringUnavailable, OSError):
            _avail = False
            return _avail
        try:
            import tempfile
            with tempfile.TemporaryFile() as f:
                f.write(b"probe")
                f.flush()
                ring.submit_fsync(f.fileno(), 1)
                for _ in range(64):
                    done = ring.wait_completions(block=True)
                    if done:
                        _avail = done[0][0] == 1 and done[0][1] == 0
                        break
                else:
                    _avail = False
        except OSError:
            _avail = False
        finally:
            ring.close()
        return bool(_avail)
