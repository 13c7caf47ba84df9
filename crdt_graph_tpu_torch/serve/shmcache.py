"""Cross-process shared-memory encoded-body cache.

The port of the reference package's ``serve/shmcache`` (host-side only:
no tensor, no card).  Segment names, the manifest and the segment
layout are the reference's, byte for byte, so a reference process and a
port process on one host serving the same converged document share ONE
segment.

The per-snapshot readcache (serve/snapshot.py) proved
one-encode-per-generation in process: every reader of generation ``k``
gets the SAME bytes object.  A many-process host — ``--fleet N``
workers, a watch tier, sidecar pullers — still pays that encode (and
the resident copy) once PER PROCESS.  This module promotes the two
hot whole-doc bodies (``GET /docs/{id}`` values wire, ``GET .../clock``
wire) to a host-shared tier: one ``multiprocessing.shared_memory``
segment per (doc, generation-fingerprint) holds both bodies, and every
process maps the same pages read-only instead of re-encoding.

Design contract
---------------
* **Content-addressed**: the segment name hashes
  ``(namespace, doc_id, state_fingerprint)``.  The state fingerprint is
  replica-independent (serve/snapshot.py), so converged fleet replicas
  of one document land on the SAME segment no matter which process
  encoded first — that is the single-encode-per-host win.
* **Invalidation is still the publish pointer swap**: a snapshot's
  bodies are immutable, so the segment is immutable after its one-time
  fill; a new generation gets a new fingerprint and a new segment.  The
  old generation's claim is released on the swap (maintenance lane,
  inline fallback) and the segment is unlinked when the LAST claimant
  releases.
* **Refcount via manifest**: a tiny flock-serialized JSON manifest maps
  segment name -> {doc, fingerprint, size, pids}.  A pid claims on
  create/attach and releases on retire/close; a scavenge pass drops
  claims of dead pids (``os.kill(pid, 0)``) so a SIGKILLed worker never
  leaks segments past the next writer.
* **Unlink is safe under readers**: POSIX shm unlink removes the NAME;
  existing mappings (a parked watcher's memoryview, a mid-write reader)
  stay valid until the last map dies.  The cache therefore never
  invalidates served views — it parks un-closeable mappings (views
  still exported) on a zombie list and retries the close lazily.
* **Fail-open**: any OS-level failure (no /dev/shm, ENOSPC, a torn
  manifest) degrades to the process-local readcache path — same bytes,
  one copy per process, never an error surfaced to a reader.

``GRAFT_SHMCACHE=1`` arms the tier (default off);
``GRAFT_SHMCACHE_NS`` isolates co-hosted clusters (and tests).
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import tempfile
import threading
import time
from typing import Any, Dict, Optional, Tuple

try:                                     # gated: platforms without
    from multiprocessing import shared_memory as _shm_mod  # POSIX shm
except ImportError:                      # pragma: no cover
    _shm_mod = None

# segment layout: | magic 8s | values_len u64 | clock_len u64 | values
# bytes | clock bytes |.  The magic is written LAST (after the payload)
# so an attacher racing the creator's fill can tell "not ready yet"
# from "ready" without any cross-process lock on the read path.
_HDR = struct.Struct("<8sQQ")
_MAGIC = b"GRAFTSHM"
_ATTACH_POLL_S = 0.002
_ATTACH_WAIT_S = 0.25


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:          # exists, different uid
        return True
    except OSError:
        return False
    return True


def _untrack(shm) -> None:
    """Detach the segment from this process's resource tracker: the
    MANIFEST owns the unlink lifecycle, not interpreter exit — the
    tracker unlinking a shared segment when ONE process exits would
    yank the name out from under every other claimant (the well-known
    3.8+ double-unlink hazard)."""
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


def _shm_unlink(name: str) -> None:
    """Unlink a segment BY NAME (scavenging a dead pid's leftovers —
    no SharedMemory object in hand, and attaching just to unlink would
    re-register it)."""
    try:
        _shm_mod._posixshmem.shm_unlink("/" + name)
    except FileNotFoundError:
        pass
    except OSError:
        pass


class ShmCacheStats:
    """Engine-wide shared-tier telemetry, separate from the per-doc
    :class:`~crdt_graph_tpu_torch.serve.snapshot.ReadCacheStats` (which keeps
    counting first-touch/encode work exactly as before).  Rendered as ``crdt_shmcache_*``."""

    __slots__ = ("_mu", "hits", "misses", "attach_failed",
                 "shared_bytes", "released", "scavenged")

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self.hits = 0            # attached a segment another process
        #                          (or an earlier snapshot here) filled
        self.misses = 0          # this process encoded + created
        self.attach_failed = 0   # degraded to the process-local path
        self.shared_bytes = 0    # payload bytes this process serves
        #                          out of shared segments
        self.released = 0        # claims dropped on publish swap/close
        self.scavenged = 0       # dead-pid segments unlinked

    def hit(self, nbytes: int) -> None:
        with self._mu:
            self.hits += 1
            self.shared_bytes += int(nbytes)

    def miss(self, nbytes: int) -> None:
        with self._mu:
            self.misses += 1
            self.shared_bytes += int(nbytes)

    def failed(self) -> None:
        with self._mu:
            self.attach_failed += 1

    def note_released(self, n: int = 1) -> None:
        with self._mu:
            self.released += n

    def note_scavenged(self, n: int = 1) -> None:
        with self._mu:
            self.scavenged += n

    def snapshot(self) -> Dict[str, Any]:
        with self._mu:
            return {"hits": self.hits, "misses": self.misses,
                    "attach_failed": self.attach_failed,
                    "shared_bytes": self.shared_bytes,
                    "released": self.released,
                    "scavenged": self.scavenged}


class ShmBodyCache:
    """One per engine.  Thread-safe; every public entry point is
    fail-open (returns ``None`` / no-ops on OS trouble)."""

    def __init__(self, namespace: Optional[str] = None):
        if _shm_mod is None:
            raise OSError("multiprocessing.shared_memory unavailable")
        self.namespace = (namespace
                          or os.environ.get("GRAFT_SHMCACHE_NS")
                          or "host").strip() or "host"
        self.stats = ShmCacheStats()
        self._mu = threading.Lock()
        # name -> (SharedMemory, values_mv, clock_mv): mappings this
        # process serves from.  Objects stay here until released so
        # the mmap (and every served memoryview) outlives the unlink.
        self._segs: Dict[str, Tuple[Any, memoryview, memoryview]] = {}
        self._zombies: list = []     # released but views still exported
        mdir = "/dev/shm" if os.path.isdir("/dev/shm") \
            else tempfile.gettempdir()
        self._manifest = os.path.join(
            mdir, f"graftshm-{self.namespace}.manifest")
        self._closed = False

    # -- naming -----------------------------------------------------------

    def seg_name(self, doc_id: str, sfp: str) -> str:
        h = hashlib.sha1(
            f"{self.namespace}|{doc_id}|{sfp}".encode()).hexdigest()
        return f"graftshm-{self.namespace[:16]}-{h[:24]}"

    # -- manifest (flock-serialized refcounts) ----------------------------

    def _with_manifest(self, fn):
        """Run ``fn(manifest_dict) -> result`` under an exclusive flock
        on the manifest file, persisting the (possibly mutated) dict.
        A torn/absent manifest resets to empty — claims re-accrete and
        the scavenger reconciles the segments themselves."""
        import fcntl
        fd = os.open(self._manifest, os.O_RDWR | os.O_CREAT, 0o600)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            try:
                raw = os.pread(fd, os.fstat(fd).st_size, 0)
                man = json.loads(raw) if raw else {}
                if not isinstance(man, dict):
                    man = {}
            except (ValueError, OSError):
                man = {}
            out = fn(man)
            blob = json.dumps(man).encode()
            os.ftruncate(fd, 0)
            os.pwrite(fd, blob, 0)
            return out
        finally:
            os.close(fd)

    def _claim(self, name: str, doc_id: str, sfp: str,
               size: int) -> None:
        pid = os.getpid()

        def add(man):
            ent = man.setdefault(name, {"doc": doc_id, "sfp": sfp,
                                        "size": size, "pids": []})
            if pid not in ent["pids"]:
                ent["pids"].append(pid)

        self._with_manifest(add)

    def _unclaim(self, name: str) -> bool:
        """Drop this pid's claim; returns True when the segment is now
        orphaned (caller unlinks)."""
        pid = os.getpid()

        def drop(man):
            ent = man.get(name)
            if ent is None:
                return True          # already unlinked by someone
            ent["pids"] = [p for p in ent["pids"] if p != pid]
            if not ent["pids"]:
                del man[name]
                return True
            return False

        return self._with_manifest(drop)

    def scavenge(self) -> int:
        """Dead-pid sweep: claims of exited processes are dropped and
        fully-orphaned segments unlinked — a SIGKILLed fleet worker's
        segments outlive it only until the next sweep."""
        if self._closed:
            return 0

        def sweep(man):
            gone = []
            for name, ent in list(man.items()):
                live = [p for p in ent.get("pids", ())
                        if _pid_alive(p)]
                if live:
                    ent["pids"] = live
                else:
                    del man[name]
                    gone.append(name)
            return gone

        try:
            gone = self._with_manifest(sweep)
        except OSError:
            return 0
        for name in gone:
            _shm_unlink(name)
        if gone:
            self.stats.note_scavenged(len(gone))
        return len(gone)

    # -- the tier ---------------------------------------------------------

    def get_or_publish(self, doc_id: str, sfp: str, encode):
        """Serve generation ``sfp`` of ``doc_id`` out of the shared
        tier: attach the segment if any process already filled it,
        else ``encode() -> (values_bytes, clock_bytes)`` locally and
        publish it for the rest of the host.  Returns
        ``(values_view, clock_view, seg_name)`` or ``None`` (caller
        falls back to its process-local path).  Idempotent per
        process+generation — re-entry returns the cached mapping
        without recounting."""
        if self._closed:
            return None
        name = self.seg_name(doc_id, sfp)
        with self._mu:
            got = self._segs.get(name)
        if got is not None:
            return got[1], got[2], name
        try:
            return self._attach_or_create(name, doc_id, sfp, encode)
        except OSError:
            self.stats.failed()
            return None

    def _attach_or_create(self, name, doc_id, sfp, encode):
        try:
            seg = _shm_mod.SharedMemory(name=name)
            created = False
        except FileNotFoundError:
            seg, created = None, True
        if not created:
            _untrack(seg)
            out = self._wait_ready(seg, name, doc_id, sfp)
            if out is None:
                self.stats.failed()
                return None
            return out
        vbody, cbody = encode()
        size = _HDR.size + len(vbody) + len(cbody)
        try:
            seg = _shm_mod.SharedMemory(name=name, create=True,
                                        size=size)
        except FileExistsError:
            # lost the create race — attach the winner's fill
            seg = _shm_mod.SharedMemory(name=name)
            _untrack(seg)
            out = self._wait_ready(seg, name, doc_id, sfp)
            if out is None:
                self.stats.failed()
                return None
            return out
        _untrack(seg)
        buf = seg.buf
        buf[_HDR.size:_HDR.size + len(vbody)] = vbody
        buf[_HDR.size + len(vbody):size] = cbody
        # payload in place — NOW stamp the ready header
        _HDR.pack_into(buf, 0, _MAGIC, len(vbody), len(cbody))
        self._claim(name, doc_id, sfp, size)
        vmv = buf[_HDR.size:_HDR.size + len(vbody)]
        cmv = buf[_HDR.size + len(vbody):size]
        with self._mu:
            self._segs[name] = (seg, vmv, cmv)
        self.stats.miss(len(vbody) + len(cbody))
        return vmv, cmv, name

    def _wait_ready(self, seg, name, doc_id, sfp):
        """Attached an existing segment: poll the ready magic (the
        creator stamps it after the payload), slice the body views,
        claim.  ``None`` on a segment that never goes ready (creator
        died mid-fill — the scavenger will reap it)."""
        deadline = time.monotonic() + _ATTACH_WAIT_S
        buf = seg.buf
        while True:
            if len(buf) >= _HDR.size:
                magic, vlen, clen = _HDR.unpack_from(buf, 0)
                if magic == _MAGIC:
                    break
            if time.monotonic() >= deadline:
                return None
            time.sleep(_ATTACH_POLL_S)
        if _HDR.size + vlen + clen > len(buf):
            return None                      # torn/foreign segment
        vmv = buf[_HDR.size:_HDR.size + vlen]
        cmv = buf[_HDR.size + vlen:_HDR.size + vlen + clen]
        self._claim(name, doc_id, sfp, _HDR.size + vlen + clen)
        with self._mu:
            prior = self._segs.get(name)
            if prior is not None:
                # another thread of THIS process raced us in — serve
                # its mapping, quietly drop ours (no double count)
                self._drop_seg_obj(seg)
                return prior[1], prior[2], name
            self._segs[name] = (seg, vmv, cmv)
        self.stats.hit(vlen + clen)
        return vmv, cmv, name

    # -- retire / lifecycle -----------------------------------------------

    def release(self, name: str) -> None:
        """Publish-swap retirement of one generation's claim (this
        process).  Unlinks the segment when the last claimant leaves;
        the mapping itself is closed only once no served memoryview is
        outstanding (zombie-parked otherwise) — a parked watcher's
        view stays valid across both the swap AND the unlink."""
        with self._mu:
            got = self._segs.pop(name, None)
        if got is None:
            return
        try:
            if self._unclaim(name):
                _shm_unlink(name)
        except OSError:
            pass
        self.stats.note_released()
        self._drop_seg_obj(got[0])
        self._reap_zombies()

    def _drop_seg_obj(self, seg) -> None:
        try:
            _shm_mod.SharedMemory.close(seg)
        except BufferError:
            # served views still exported — the map MUST outlive them.
            # Shadow the instance's close so ``__del__`` at interpreter
            # exit doesn't spray "Exception ignored" for a mapping the
            # OS reclaims anyway (retries below call the class method).
            seg.close = lambda: None
            with self._mu:
                self._zombies.append(seg)
        except OSError:
            pass

    def _reap_zombies(self) -> None:
        with self._mu:
            zombies, self._zombies = self._zombies, []
        for seg in zombies:
            self._drop_seg_obj(seg)

    def close(self) -> None:
        """Engine shutdown: drop every claim this process holds (the
        mappings themselves follow the zombie rule — process exit
        reclaims whatever stayed pinned by exported views)."""
        if self._closed:
            return
        with self._mu:
            segs, self._segs = self._segs, {}
        for name, (seg, _v, _c) in segs.items():
            try:
                if self._unclaim(name):
                    _shm_unlink(name)
            except OSError:
                pass
            self.stats.note_released()
            self._drop_seg_obj(seg)
        try:
            self.scavenge()
        except Exception:
            pass
        # the (tiny) manifest file deliberately stays: unlinking it
        # races a concurrent claim onto the dead inode, and a claim
        # invisible to future scavenges is a leaked segment
        self._closed = True
