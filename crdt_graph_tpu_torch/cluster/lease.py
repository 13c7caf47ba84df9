"""Replica-id leases over the coordination KV: the reference's
"coordinating server that assigns replica ids" (PAPER.md survey §1),
made crash-safe and peer-to-peer.

Each serving process claims one numeric id slot (``lease/<id>``) with a
TTL lease.  The lease record carries a **fencing token** — a counter
bumped on every (re-)acquisition of the slot, never on renewal — so any
two holders of the same id are totally ordered: a deposed node that
wakes up after a GC pause and tries to renew finds a bumped token and
learns it was fenced (``LeaseLost``) instead of silently acting as a
live member.  Crash-safe re-acquisition is the same mechanism: a node
that restarts under its stable NAME reclaims its old slot immediately
(same name supersedes its own dead incarnation without waiting out the
TTL), while a slot whose holder vanished becomes claimable to anyone
once its TTL passes.

The lease table IS the membership table: :meth:`LeaseService.members`
returns the unexpired leases, and the consistent-hash ring
(cluster/ring.py) is derived from exactly that, so a server whose lease
lapses drops out of routing everywhere within one TTL with no extra
protocol.

Liveness math: renewal runs every ``ttl/3`` (:class:`LeaseKeeper`), so
one lost heartbeat never drops a lease, and a genuinely dead node is
out of the ring within ``ttl``.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Callable, Dict, Optional


class LeaseError(Exception):
    """No id slot could be claimed (fleet full / KV contention)."""


class LeaseLost(Exception):
    """The lease is no longer ours: expired and re-claimed (fenced by a
    bumped token) or force-expired by an operator."""


@dataclasses.dataclass
class Lease:
    id: int          # the leased numeric replica id (the slot)
    name: str        # stable node name (survives restarts)
    addr: str        # advertised HTTP address, "host:port"
    token: int       # fencing token: bumps on every (re-)acquisition
    expires: float   # wall-clock expiry (KV readers compare clocks)

    def record(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def parse(cls, raw: str) -> "Lease":
        return cls(**json.loads(raw))


class LeaseService:
    """Lease protocol over any :mod:`~crdt_graph_tpu_torch.cluster.kv`
    store.  ``clock`` is injectable for deterministic expiry tests."""

    PREFIX = "lease/"

    def __init__(self, kv, ttl_s: float = 5.0, max_ids: int = 64,
                 clock: Callable[[], float] = time.time):
        self.kv = kv
        self.ttl_s = ttl_s
        self.max_ids = max_ids
        self.clock = clock

    # -- protocol ---------------------------------------------------------

    def _slot(self, i: int):
        got = self.kv.get(f"{self.PREFIX}{i}")
        if got is None:
            return None, 0
        raw, version = got
        try:
            return Lease.parse(raw), version
        except (ValueError, TypeError, KeyError):
            return None, version   # unparseable record: claimable slot

    def acquire(self, name: str, addr: str) -> Lease:
        """Claim an id slot: the node's own old slot first (same name —
        crash-safe re-acquisition, no TTL wait), else the lowest
        absent/expired slot.  Every claim writes ``token + 1`` so the
        previous incarnation is fenced the moment the CAS lands."""
        for attempt in range(8):
            now = self.clock()
            candidates = []
            for i in range(self.max_ids):
                cur, version = self._slot(i)
                if cur is not None and cur.name == name:
                    candidates.insert(0, (i, cur, version))  # reclaim
                elif cur is None or cur.expires <= now:
                    candidates.append((i, cur, version))
            for i, cur, version in candidates:
                lease = Lease(id=i, name=name, addr=addr,
                              token=(cur.token if cur else 0) + 1,
                              expires=now + self.ttl_s)
                if self.kv.cas(f"{self.PREFIX}{i}", lease.record(),
                               version):
                    return lease
            # every candidate CAS lost a race; rescan
        raise LeaseError(f"no claimable id slot among {self.max_ids} "
                         f"for {name!r}")

    def renew(self, lease: Lease) -> Lease:
        """Extend our lease.  Raises :class:`LeaseLost` when the stored
        record is no longer ours (bumped token = fenced; changed name =
        slot re-claimed; vanished = released/expired+collected)."""
        cur, version = self._slot(lease.id)
        if cur is None or cur.name != lease.name \
                or cur.token != lease.token:
            raise LeaseLost(f"slot {lease.id} no longer held by "
                            f"{lease.name!r} (token {lease.token})")
        renewed = dataclasses.replace(lease,
                                      expires=self.clock() + self.ttl_s)
        if not self.kv.cas(f"{self.PREFIX}{lease.id}", renewed.record(),
                           version):
            raise LeaseLost(f"slot {lease.id} CAS lost mid-renewal")
        return renewed

    def release(self, lease: Lease) -> bool:
        """Graceful shutdown: drop the slot iff still ours, so the
        membership change is immediate instead of waiting out the TTL."""
        cur, version = self._slot(lease.id)
        if cur is None or cur.name != lease.name \
                or cur.token != lease.token:
            return False
        return self.kv.delete(f"{self.PREFIX}{lease.id}", version)

    def expire_now(self, name: str) -> bool:
        """Operator force-expiry (manual failover; the deterministic
        chaos tests use it instead of waiting out a TTL): zero the
        named node's expiry, keeping the token — the next claimant
        bumps it, fencing the victim exactly as a natural expiry
        would."""
        for i in range(self.max_ids):
            cur, version = self._slot(i)
            if cur is not None and cur.name == name:
                return self.kv.cas(
                    f"{self.PREFIX}{i}",
                    dataclasses.replace(cur, expires=0.0).record(),
                    version)
        return False

    def members(self) -> Dict[str, Lease]:
        """The live membership: name → unexpired lease.  The ring
        (cluster/ring.py) is built from exactly this."""
        now = self.clock()
        out: Dict[str, Lease] = {}
        for key in self.kv.keys(self.PREFIX):
            got = self.kv.get(key)
            if got is None:
                continue
            try:
                lease = Lease.parse(got[0])
            except (ValueError, TypeError, KeyError):
                continue
            if lease.expires > now:
                out[lease.name] = lease
        return out


class LeaseKeeper(threading.Thread):
    """Background renewal at ``ttl/3``; on :class:`LeaseLost`
    re-acquires under the same name (bumped token) and reports the
    change through ``on_change`` so the owner can refresh identity
    headers.  ``losses``/``reacquired`` feed the ``crdt_cluster_*``
    prom families."""

    def __init__(self, service: LeaseService, lease: Lease,
                 on_change: Optional[Callable[[Lease], None]] = None):
        super().__init__(name=f"lease-keeper-{lease.name}", daemon=True)
        self.service = service
        self.lease = lease
        self.on_change = on_change
        self.losses = 0
        self.reacquired = 0
        self.last_error: Optional[str] = None
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def run(self) -> None:
        interval = max(0.05, self.service.ttl_s / 3.0)
        while not self._stop.wait(interval):
            try:
                self.lease = self.service.renew(self.lease)
            except LeaseLost as e:
                self.losses += 1
                self.last_error = str(e)
                try:
                    self.lease = self.service.acquire(self.lease.name,
                                                      self.lease.addr)
                    self.reacquired += 1
                    if self.on_change is not None:
                        self.on_change(self.lease)
                except LeaseError as e2:
                    self.last_error = str(e2)
            except Exception as e:   # noqa: BLE001 — KV outage: keep
                self.last_error = repr(e)   # trying, lease may survive
