"""Mutable host-side replica state: the engine's delta fast path.

A copy of the reference package's ``host_tree`` (numpy only), with the
statuses taken from the port's ``ops.merge``.

The batched kernel (ops/merge.py) is the right shape for BIG merges —
O(n log n) work at O(log n) parallel depth — but a 1-op remote delta on an
n-op document must not cost a full re-materialisation.  The reference
applies one op in O(depth·log b + siblings) (Internal/Node.elm:51-104);
``HostTree`` restores that asymptotic for the array engine: the reference's
pointer structure — RGA branches as sibling linked lists with an implicit
sentinel head (Internal/Node.elm:25-48) — rebuilt on flat numpy slot
arrays, mutated sequentially in O(depth + sibling-scan) per op, with an
undo journal for batch atomicity (CRDTree.elm:224-232).

Division of labour inside ``TpuTree`` (engine.py):

- small deltas (local edits, per-op serving traffic) apply here, host-side,
  and every interactive read (get/walk/children/visible_values) resolves
  against these arrays — no device round-trip, no re-sort, slots stable;
- large deltas (anti-entropy catch-up, bulk merges) go through the batched
  kernel; afterwards the mirror is rebuilt from the resulting ``NodeTable``
  in one vectorised pass (``from_table``).

Statuses use the kernel's codes (ops/merge.py APPLIED/ALREADY_APPLIED/
NOT_FOUND/INVALID_PATH).  Because application here is sequential in batch
order, statuses match the reference exactly even for non-causally-ordered
batches — stronger than the kernel's causal-order guarantee (ops/merge.py
module docstring).
"""
from __future__ import annotations

from typing import Any, Iterator, List, Optional, Tuple

import numpy as np

from .ops.merge import ALREADY_APPLIED, APPLIED, INVALID_PATH, NOT_FOUND

ROOT = 0
NIL = -1


class HostTree:
    """Slot-array tree with per-branch sibling linked lists.

    Slot 0 is the root.  Slots are append-only: tombstoning never moves or
    frees a slot, so outstanding views into the mirror stay valid across
    edits (the kernel path compacts slots and invalidates views instead).
    """

    __slots__ = ("ts", "parent", "depth", "value_ref", "tomb", "first",
                 "nxt", "prv", "paths", "n", "nvis", "max_depth",
                 "_ts2slot", "values", "journal", "vis_cache")

    def __init__(self, max_depth: int, capacity: int = 64):
        cap = max(capacity, 8)
        self.max_depth = max_depth
        self.ts = np.zeros(cap, np.int64)
        self.parent = np.full(cap, ROOT, np.int32)
        self.depth = np.zeros(cap, np.int32)
        self.value_ref = np.full(cap, -1, np.int32)
        self.tomb = np.zeros(cap, bool)
        self.first = np.full(cap, NIL, np.int32)   # first child (RGA order)
        self.nxt = np.full(cap, NIL, np.int32)     # next sibling (RGA order)
        self.prv = np.full(cap, NIL, np.int32)     # prev sibling (RGA order)
        self.paths = np.zeros((cap, max_depth), np.int64)
        self.n = 1                                  # slot 0 = root
        self.nvis = 0                               # visible-node count
        self._ts2slot: Optional[dict] = {}
        self.values: List[Any] = []
        # undo journal for batch atomicity; entries are applied ops in
        # order, rolled back LIFO
        self.journal: List[tuple] = []
        # visible-values-in-doc-order cache: populated by the persisted
        # materialization loader (engine._load_matz_mirror) so the
        # first read after a restore skips the O(n) visible traversal;
        # invalidated by ANY applied mutation
        self.vis_cache: Optional[List[Any]] = None

    @property
    def ts2slot(self) -> dict:
        """timestamp → slot index.  Built lazily after a bulk
        construction (``from_arrays`` defers it: a restored mirror
        that only ever serves reads never needs the dict)."""
        if self._ts2slot is None:
            self._ts2slot = dict(zip(self.ts[1:self.n].tolist(),
                                     range(1, self.n)))
        return self._ts2slot

    @ts2slot.setter
    def ts2slot(self, d: Optional[dict]) -> None:
        self._ts2slot = d

    # -- construction ----------------------------------------------------

    @classmethod
    def from_table(cls, table, values, max_depth: int) -> "HostTree":
        """Vectorised rebuild from a kernel ``NodeTable`` (host numpy).

        Existing nodes (tombstones and dead-subtree members included — the
        traversals below skip them exactly like the kernel's masks do) are
        compacted into slots 1..n in document order; sibling linked lists
        come from one (parent, doc_index) lexsort.
        """
        exists = np.asarray(table.exists)
        doc = np.asarray(table.doc_index)
        idx = np.nonzero(exists)[0]
        # document order makes host slot ids monotone in doc order — not
        # load-bearing, but keeps dumps readable and scans cache-friendly
        idx = idx[np.argsort(doc[idx], kind="stable")]
        k = idx.size
        t = cls(max_depth, capacity=max(64, int(k * 2)))
        t.n = k + 1
        remap = np.zeros(np.asarray(table.ts).shape[0], np.int32)
        remap[idx] = np.arange(1, k + 1, dtype=np.int32)
        t.ts[1:k + 1] = np.asarray(table.ts)[idx]
        t.parent[1:k + 1] = remap[np.asarray(table.parent)[idx]]
        t.depth[1:k + 1] = np.asarray(table.depth)[idx]
        t.value_ref[1:k + 1] = np.asarray(table.value_ref)[idx]
        t.tomb[1:k + 1] = np.asarray(table.tombstone)[idx]
        # the kernel table's path plane is depth-bucketed (codec.packed);
        # widen into the mirror's full-width zero-padded plane
        tbl_paths = np.asarray(table.paths)
        t.paths[1:k + 1, :tbl_paths.shape[1]] = tbl_paths[idx]
        # sibling lists: group children by parent, doc order within group
        hp = t.parent[1:k + 1]
        order = np.lexsort((np.arange(k), hp))      # parent asc, doc asc
        slots = (order + 1).astype(np.int32)
        ps = hp[order]
        same = ps[1:] == ps[:-1]
        if k:
            t.nxt[slots[:-1]] = np.where(same, slots[1:], NIL)
            t.nxt[slots[-1]] = NIL
            t.prv[slots[1:]] = np.where(same, slots[:-1], NIL)
            t.prv[slots[0]] = NIL
            starts = np.concatenate([[True], ~same])
            t.first[ps[starts]] = slots[starts]
        t.ts2slot = dict(zip(t.ts[1:k + 1].tolist(), range(1, k + 1)))
        t.values = list(values)
        t.nvis = int(np.asarray(table.num_visible))
        return t

    # -- persisted materialization (engine.write_matz round trip) ---------

    def export_arrays(self, copy: bool = False) -> dict:
        """The mirror's slot arrays for the materialization artifact
        (engine.TpuTree.write_matz).  ``paths`` is OMITTED — it
        rebuilds from (parent, ts, depth) in :meth:`from_arrays`, and
        at scale it is by far the widest plane (n × max_depth × 8 B).
        ``vis_refs`` is the visible sequence's value refs in document
        order: the restored first read becomes one list indexing pass
        instead of an O(n) linked-list traversal.

        ``copy=True`` returns snapshot COPIES instead of live views —
        the background matz export (engine.TpuTree.matz_snapshot)
        captures the mirror copy-on-export on the scheduler thread so
        the maintenance worker can serialize while this mirror keeps
        applying ops; a view handed across that thread boundary would
        tear."""
        n = self.n
        vis_refs = np.fromiter(
            (self.value_ref[s] for s in self.iter_visible()),
            dtype=np.int32, count=self.nvis)
        out = {"ts": self.ts[:n], "parent": self.parent[:n],
               "depth": self.depth[:n],
               "value_ref": self.value_ref[:n], "tomb": self.tomb[:n],
               "first": self.first[:n], "nxt": self.nxt[:n],
               "prv": self.prv[:n], "vis_refs": vis_refs}
        if copy:
            out = {k: np.array(v, copy=True) for k, v in out.items()}
        return out

    @classmethod
    def from_arrays(cls, arrs: dict, values: List[Any],
                    max_depth: int, nvis: int) -> "HostTree":
        """Inverse of :meth:`export_arrays`: rebuild the mirror from
        persisted slot arrays.  ``paths`` rebuilds vectorized level by
        level (a child's path = its parent's path + its own ts);
        ``ts2slot`` stays lazy (read-only consumers never pay it).
        Raises ``ValueError`` on structurally inconsistent arrays —
        the caller maps it into the typed corrupt-artifact fallback."""
        names = ("ts", "parent", "depth", "value_ref", "tomb",
                 "first", "nxt", "prv")
        n = int(np.asarray(arrs["ts"]).shape[0])
        if n < 1:
            raise ValueError("matz arrays hold no root slot")
        t = cls(max_depth, capacity=n)
        for name, dtype in zip(names, (np.int64, np.int32, np.int32,
                                       np.int32, bool, np.int32,
                                       np.int32, np.int32)):
            a = np.asarray(arrs[name])
            if a.shape != (n,):
                raise ValueError(f"matz array {name} shape {a.shape}")
            getattr(t, name)[:n] = a.astype(dtype, copy=False)
        t.n = n
        t.nvis = int(nvis)
        depth = t.depth[:n]
        if n > 1:
            d_max = int(depth.max())
            if d_max > max_depth or int(depth[1:].min()) < 1:
                raise ValueError("matz depth column out of range")
            parent = t.parent[:n]
            if int(parent.min()) < 0 or int(parent.max()) >= n:
                raise ValueError("matz parent column out of range")
            for d in range(1, d_max + 1):
                sl = np.nonzero(depth == d)[0]
                if not sl.size:
                    continue
                if d > 1:
                    if np.any(depth[parent[sl]] != d - 1):
                        raise ValueError("matz parent depth mismatch")
                    t.paths[sl, :d - 1] = t.paths[parent[sl], :d - 1]
                t.paths[sl, d - 1] = t.ts[sl]
        t.values = list(values)
        t.ts2slot = None        # lazy (property builds on first use)
        return t

    # -- growth ----------------------------------------------------------

    def _grow(self) -> None:
        cap = self.ts.shape[0] * 2
        for name in ("ts", "parent", "depth", "value_ref", "tomb", "first",
                     "nxt", "prv"):
            old = getattr(self, name)
            new = np.empty(cap, old.dtype)
            new[:self.n] = old[:self.n]
            setattr(self, name, new)
        old = self.paths
        new = np.zeros((cap, self.max_depth), np.int64)
        new[:self.n] = old[:self.n]
        self.paths = new

    # -- op application (parity: Internal/Node.elm:51-163) ---------------

    def _descend(self, prefix: Tuple[int, ...]) -> Optional[int]:
        """Walk the claimed parent prefix from the root; returns the parent
        slot, INVALID_PATH (as negative code) on a broken chain, or
        ALREADY_APPLIED when the descent crosses a tombstone (edits under a
        deleted branch are silent no-ops, Internal/Node.elm:144-146)."""
        cur = ROOT
        for el in prefix:
            s = self.ts2slot.get(el)
            if s is None or self.parent[s] != cur:
                return -INVALID_PATH
            if self.tomb[s]:
                return -ALREADY_APPLIED
            cur = s
        return cur

    def apply_add(self, ts: int, path: Tuple[int, ...], value: Any) -> int:
        d = len(path)
        if d == 0 or d > self.max_depth:
            return INVALID_PATH
        cur = self._descend(path[:-1])
        if cur < 0:
            return -cur
        if ts <= 0:
            # collides with the branch-head sentinel: the reference finds
            # an existing child and reports AlreadyApplied
            return ALREADY_APPLIED
        if ts in self.ts2slot:
            return ALREADY_APPLIED                    # idempotence
        anchor = path[-1]
        if anchor == 0:
            prev, cand = NIL, self.first[cur]
        else:
            a = self.ts2slot.get(anchor)
            if a is None or self.parent[a] != cur:
                return NOT_FOUND                      # anchor missing
            prev, cand = a, self.nxt[a]
        # RGA rule: among concurrent inserts after one anchor, higher ts
        # sits closer to it — skip right past larger-ts siblings
        # (Internal/Node.elm:93-104)
        while cand != NIL and self.ts[cand] > ts:
            prev, cand = cand, self.nxt[cand]
        if self.n == self.ts.shape[0]:
            self._grow()
        slot = self.n
        self.n += 1
        self.ts[slot] = ts
        self.parent[slot] = cur
        self.depth[slot] = d
        self.tomb[slot] = False
        self.first[slot] = NIL
        self.value_ref[slot] = len(self.values)
        self.values.append(value)
        row = self.paths[slot]
        row[:] = 0
        if d > 1:
            row[:d - 1] = path[:-1]
        row[d - 1] = ts                                # stamped path
        if prev == NIL:
            self.first[cur] = slot
        else:
            self.nxt[prev] = slot
        self.nxt[slot] = cand
        self.prv[slot] = prev
        if cand != NIL:
            self.prv[cand] = slot
        self.ts2slot[ts] = slot
        self.nvis += 1          # a fresh add is visible (descent proved
                                # no tombstoned ancestor)
        self.vis_cache = None
        self.journal.append(("add", slot, cur, prev))
        return APPLIED

    def apply_delete(self, path: Tuple[int, ...]) -> int:
        d = len(path)
        if d == 0 or d > self.max_depth:
            return INVALID_PATH
        cur = self._descend(path[:-1])
        if cur < 0:
            return -cur
        target = path[-1]
        if target == 0:
            # the branch-head sentinel is a tombstone already
            return ALREADY_APPLIED
        s = self.ts2slot.get(target)
        if s is None or self.parent[s] != cur:
            return NOT_FOUND
        if self.tomb[s]:
            return ALREADY_APPLIED
        # tombstoning discards the subtree (Internal/Node.elm:237-238):
        # the visible count drops by the target plus its visible
        # descendants — O(subtree), O(1) for leaf deletes
        dvis = 1 + sum(1 for _ in self.iter_visible(s))
        self.tomb[s] = True
        self.nvis -= dvis
        self.vis_cache = None
        self.journal.append(("del", s, dvis))
        return APPLIED

    # -- batch atomicity -------------------------------------------------

    def savepoint(self) -> int:
        return len(self.journal)

    def rollback(self, savepoint: int) -> None:
        """Undo journal entries back to ``savepoint`` (LIFO)."""
        if len(self.journal) > savepoint:
            self.vis_cache = None
        while len(self.journal) > savepoint:
            entry = self.journal.pop()
            if entry[0] == "add":
                _, slot, parent, prev = entry
                cand = self.nxt[slot]
                if prev == NIL:
                    self.first[parent] = cand
                else:
                    self.nxt[prev] = cand
                if cand != NIL:
                    self.prv[cand] = prev
                del self.ts2slot[int(self.ts[slot])]
                self.values.pop()
                self.n -= 1
                self.nvis -= 1
                assert self.n == slot, "non-LIFO rollback"
            else:
                _, slot, dvis = entry
                self.tomb[slot] = False
                self.nvis += dvis

    # -- traversal (parity: Internal/Node.elm:166-268) -------------------

    def iter_siblings(self, parent_slot: int) -> Iterator[int]:
        """ALL chain members (tombstones included), RGA order."""
        s = self.first[parent_slot]
        while s != NIL:
            yield int(s)
            s = self.nxt[s]

    def iter_visible_children(self, slot: int) -> Iterator[int]:
        s = self.first[slot]
        while s != NIL:
            if not self.tomb[s]:
                yield int(s)
            s = self.nxt[s]

    def iter_visible(self, start_slot: int = ROOT) -> Iterator[int]:
        """Visible nodes of ``start_slot``'s subtree in document order
        (pre-order; tombstones pruned with their subtrees)."""
        stack = [self.first[start_slot]]
        while stack:
            s = stack[-1]
            if s == NIL:
                stack.pop()
                continue
            stack[-1] = self.nxt[s]
            if not self.tomb[s]:
                yield int(s)
                if self.first[s] != NIL:
                    stack.append(self.first[s])

    def iter_visible_after(self, slot: int) -> Iterator[int]:
        """Visible nodes after ``slot``'s subtree: the remainder of its
        sibling list, with full descents (the resumable-walk contract,
        CRDTree.elm:583-625)."""
        s = self.nxt[slot]
        while s != NIL:
            if not self.tomb[s]:
                yield int(s)
                yield from self.iter_visible(int(s))
            s = self.nxt[s]

    def prev_for(self, slot: int) -> Optional[int]:
        """The reference's predecessor probe (CRDTree.elm:573-577): nearest
        visible left sibling, else the FIRST member of the leading
        tombstone run, else None when ``slot`` heads its chain.  Cost is
        O(adjacent tombstone run), not O(chain position) — the ``prv``
        pointers exist for exactly this."""
        s = self.prv[slot]
        if s == NIL:
            return None
        last = s
        while s != NIL:
            if not self.tomb[s]:
                return int(s)
            last = s
            s = self.prv[s]
        return int(last)

    def path_of(self, slot: int) -> Tuple[int, ...]:
        return tuple(int(x) for x in self.paths[slot, :self.depth[slot]])

    def get_slot(self, path: Tuple[int, ...]) -> Optional[int]:
        """Slot at ``path`` — tombstones included, nodes under a deleted
        branch excluded (their subtree left the tree,
        Internal/Node.elm:237-238)."""
        d = len(path)
        if d == 0 or d > self.max_depth:
            return None
        cur = self._descend(path[:-1])
        if cur < 0:
            return None
        s = self.ts2slot.get(path[-1])
        if s is None or self.parent[s] != cur:
            return None
        return s

    def is_dead(self, slot: int) -> bool:
        """True when some STRICT ancestor is tombstoned — the node left the
        tree with its deleted branch (Internal/Node.elm:237-238).  O(depth).
        Only held views can reach dead slots; lookups exclude them."""
        s = self.parent[slot]
        while s != ROOT:
            if self.tomb[s]:
                return True
            s = self.parent[s]
        return False

    def count_visible(self) -> int:
        return self.nvis
