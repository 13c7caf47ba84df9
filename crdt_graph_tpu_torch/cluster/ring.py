"""Consistent-hash doc→server routing.

Every fleet node derives the SAME ring from the same membership table
(the live lease table, cluster/lease.py — or a static member dict for
fixed deployments), so routing needs no coordination beyond membership
itself: ``primary(doc_id)`` is a pure function of ``(members,
doc_id)``.  Standard consistent hashing with virtual nodes gives the
two properties the fleet needs:

- **balance** — ``vnodes`` points per member smooth placement so D
  documents spread ~D/N per server;
- **deterministic minimal rebalancing** — when a member leaves (lease
  expiry, crash) only the documents that mapped to ITS arcs move, each
  to the next surviving point clockwise; every other document keeps
  its primary.  Pinned by tests/test_cluster.py, and the property that
  makes failover cheap: a kill reroutes the dead server's documents
  and nothing else.

Hashing is SHA-1 over stable strings (never Python ``hash``, which is
per-process salted) so every node, every process, every restart agrees.
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional, Tuple

DEFAULT_VNODES = 64


def _point(key: str) -> int:
    return int.from_bytes(hashlib.sha1(key.encode()).digest()[:8],
                          "big")


class HashRing:
    """An immutable routing table over ``{member_name: address}``."""

    def __init__(self, members: Dict[str, str],
                 vnodes: int = DEFAULT_VNODES):
        self.members = dict(members)
        self.vnodes = vnodes
        points: List[Tuple[int, str]] = []
        for name in members:
            for i in range(vnodes):
                points.append((_point(f"{name}#{i}"), name))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [n for _, n in points]

    def __len__(self) -> int:
        return len(self.members)

    def primary(self, doc_id: str) -> Optional[str]:
        """The member owning ``doc_id`` (None on an empty ring)."""
        if not self._points:
            return None
        i = bisect.bisect_right(self._points, _point(f"doc:{doc_id}"))
        return self._owners[i % len(self._owners)]

    def address(self, name: str) -> Optional[str]:
        return self.members.get(name)

    def preference(self, doc_id: str,
                   n: Optional[int] = None) -> List[str]:
        """The first ``n`` DISTINCT members clockwise from the doc's
        point — the failover order (``preference(d)[0]`` is
        :meth:`primary`)."""
        if not self._points:
            return []
        n = len(self.members) if n is None else min(n, len(self.members))
        i = bisect.bisect_right(self._points, _point(f"doc:{doc_id}"))
        out: List[str] = []
        for k in range(len(self._owners)):
            name = self._owners[(i + k) % len(self._owners)]
            if name not in out:
                out.append(name)
                if len(out) == n:
                    break
        return out

    def spread(self, doc_ids) -> Dict[str, int]:
        """Documents per member (debug/metrics view)."""
        out = {name: 0 for name in self.members}
        for d in doc_ids:
            p = self.primary(d)
            if p is not None:
                out[p] += 1
        return out
