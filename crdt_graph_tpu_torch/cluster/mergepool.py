"""Merge-worker registration over the coordination KV
(docs/MERGETIER.md §Topology).

Merge workers are a POOL, not ring members: they hold no documents, so
they register under the ring-independent ``mergeworker/`` prefix —
the consistent-hash ring (cluster/ring.py) is derived from ``lease/``
slots only and never sees them.  The record shape mirrors a lease
(name + advertised addr + wall-clock expiry, TTL-renewed), so the
same expiry rule applies: a worker that stops renewing is out of
every front-end's pool within one TTL with no extra protocol.  No
fencing token — workers are stateless per request, so two
incarnations under one name can only duplicate work, never corrupt a
commit (the front-end's input-digest check binds each response to its
request regardless of which incarnation answered).

Front-ends list the pool with :func:`list_workers` and hand the
addresses to :class:`~crdt_graph_tpu_torch.mergetier.client.MergeTierClient`
(which layers breakers on top: registration says "intended alive",
the breaker says "actually answering").
"""
from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional

PREFIX = "mergeworker/"
DEFAULT_TTL_S = 5.0


def register(kv, name: str, addr: str, ttl_s: float = DEFAULT_TTL_S,
             clock: Callable[[], float] = time.time,
             retries: int = 16) -> None:
    """Claim (or refresh) ``mergeworker/<name>``.  CAS-retried: the
    only contender for a name's key is its own previous incarnation,
    so a handful of attempts always lands."""
    from .kv import KVError
    key = f"{PREFIX}{name}"
    for _ in range(retries):
        got = kv.get(key)
        version = got[1] if got is not None else 0
        record = json.dumps({"name": name, "addr": addr,
                             "expires": clock() + ttl_s},
                            sort_keys=True)
        if kv.cas(key, record, version):
            return
    raise KVError(f"could not register merge worker {name!r}")


def deregister(kv, name: str) -> None:
    """Best-effort removal (clean shutdown); a crashed worker just
    ages out at its TTL."""
    key = f"{PREFIX}{name}"
    got = kv.get(key)
    if got is not None:
        kv.delete(key, got[1])


def list_workers(kv, clock: Callable[[], float] = time.time
                 ) -> List[Dict]:
    """Unexpired worker records, name-sorted (deterministic pool
    order across front-ends)."""
    out = []
    for key in kv.keys(PREFIX):
        got = kv.get(key)
        if got is None:
            continue
        try:
            rec = json.loads(got[0])
        except ValueError:
            continue
        if rec.get("expires", 0) > clock():
            out.append(rec)
    return sorted(out, key=lambda r: r.get("name", ""))


class MergePoolKeeper:
    """TTL renewal loop for one worker's registration — the
    ``LeaseKeeper`` shape (renew every ``ttl/3``), minus fencing."""

    def __init__(self, kv, name: str, addr: str,
                 ttl_s: float = DEFAULT_TTL_S):
        self.kv = kv
        self.name = name
        self.addr = addr
        self.ttl_s = float(ttl_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        register(kv, name, addr, ttl_s)

    def start(self) -> "MergePoolKeeper":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        from .kv import KVError
        while not self._stop.wait(self.ttl_s / 3.0):
            try:
                register(self.kv, self.name, self.addr, self.ttl_s)
            except KVError:
                # transient KV contention: the record survives until
                # its TTL, so the next beat retries with time to spare
                continue

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(10)
        deregister(self.kv, self.name)
