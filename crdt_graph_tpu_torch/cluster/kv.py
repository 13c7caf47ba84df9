"""The fleet's coordination key-value store: a tiny versioned-CAS
surface that leases, membership, and replica-id counters are built on.

The contract is deliberately minimal — ``get`` returns ``(value,
version)``, ``cas`` writes iff the caller's expected version still
holds (0 = create-only), ``delete`` is CAS-guarded too, ``keys`` lists
a prefix — because that is exactly the subset every real coordination
service offers (etcd/zookeeper/consul transactions).  Two implementations ship:

- :class:`MemoryKV` — one process, many threads (the in-process fleet
  tests and the tier-1 chaos variant share one instance);
- :class:`FileKV` — many processes, one host: one file per key under a
  spool directory, writes atomic via tmp+rename, CAS linearized by an
  ``flock`` on a single lock file (released by the kernel when a
  process dies, so a crashed node can never wedge the store — the
  crash-safety the chaos soak leans on).

A pod deployment swaps in an etcd-backed implementation of the same
five methods; nothing above this module knows the difference
(docs/CLUSTER.md §Membership).
"""
from __future__ import annotations

import fcntl
import os
import threading
from typing import Dict, List, Optional, Tuple


class KVError(Exception):
    """The store itself failed (I/O, lock acquisition) — distinct from
    a CAS miss, which is an ordinary ``False`` return."""


class MemoryKV:
    """In-process store: a dict guarded by one lock, versions counted
    per key from 1."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: Dict[str, Tuple[str, int]] = {}

    def get(self, key: str) -> Optional[Tuple[str, int]]:
        with self._lock:
            return self._data.get(key)

    def cas(self, key: str, value: str, expected_version: int) -> bool:
        """Write ``value`` iff the key's current version is
        ``expected_version`` (0 = the key must not exist).  Returns
        whether the write happened."""
        with self._lock:
            cur = self._data.get(key)
            if (cur[1] if cur else 0) != expected_version:
                return False
            self._data[key] = (value, expected_version + 1)
            return True

    def delete(self, key: str, expected_version: int) -> bool:
        with self._lock:
            cur = self._data.get(key)
            if cur is None or cur[1] != expected_version:
                return False
            del self._data[key]
            return True

    def keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))


class FileKV:
    """One-host multi-process store over a spool directory.

    Layout: key → ``<dir>/<quoted-key>`` holding ``"<version>\\n<value>"``.
    Reads are lock-free (rename is atomic, so a read sees one complete
    generation or the previous one); all writes serialize on an
    ``flock``-ed ``.lock`` file so read-modify-write CAS is atomic
    across processes AND threads (each operation opens its own fd —
    flock exclusion is per-open-file, not per-process)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock_path = os.path.join(root, ".lock")

    def _path(self, key: str) -> str:
        # keys are path-like ("lease/3"); flatten to one spool level so
        # listing stays a single readdir
        quoted = key.replace("%", "%25").replace("/", "%2F")
        return os.path.join(self.root, quoted)

    @staticmethod
    def _unquote(name: str) -> str:
        return name.replace("%2F", "/").replace("%25", "%")

    def _read(self, path: str) -> Optional[Tuple[str, int]]:
        try:
            with open(path, "r") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        head, _, value = raw.partition("\n")
        try:
            return value, int(head)
        except ValueError:
            return None   # torn legacy write; treated as absent

    def _locked(self):
        f = open(self._lock_path, "a+")
        try:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        except OSError as e:
            f.close()
            raise KVError(f"flock({self._lock_path}): {e}") from e
        return f

    def get(self, key: str) -> Optional[Tuple[str, int]]:
        return self._read(self._path(key))

    def cas(self, key: str, value: str, expected_version: int) -> bool:
        path = self._path(key)
        lock = self._locked()
        try:
            cur = self._read(path)
            if (cur[1] if cur else 0) != expected_version:
                return False
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{expected_version + 1}\n{value}")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            return True
        finally:
            fcntl.flock(lock.fileno(), fcntl.LOCK_UN)
            lock.close()

    def delete(self, key: str, expected_version: int) -> bool:
        path = self._path(key)
        lock = self._locked()
        try:
            cur = self._read(path)
            if cur is None or cur[1] != expected_version:
                return False
            os.unlink(path)
            return True
        finally:
            fcntl.flock(lock.fileno(), fcntl.LOCK_UN)
            lock.close()

    def keys(self, prefix: str = "") -> List[str]:
        out = []
        for name in os.listdir(self.root):
            if name == ".lock" or name.endswith(".tmp"):
                continue
            key = self._unquote(name)
            if key.startswith(prefix):
                out.append(key)
        return sorted(out)


def next_counter(kv, key: str, retries: int = 64) -> int:
    """Atomically increment a KV-backed counter and return its new
    value (fleet-unique CLIENT replica ids: ``POST /docs/{id}/replicas``
    on any server allocates from ``replica/{doc}``, so ids survive
    primary failover without collisions — a local per-document counter
    would restart at 1 on the new primary and hand out timestamps that
    collide with the old primary's grants)."""
    for _ in range(retries):
        cur = kv.get(key)
        value, version = (int(cur[0]), cur[1]) if cur else (0, 0)
        if kv.cas(key, str(value + 1), version):
            return value + 1
    raise KVError(f"counter {key!r}: CAS contention past {retries} "
                  "retries")
