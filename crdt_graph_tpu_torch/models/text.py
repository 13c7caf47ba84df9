"""Collaborative text buffer: the reference's companion-app workload.

The reference package exists to power a collaborative text editor
(README.md:3); this model is that application layer rebuilt on either
engine: a flat RGA of single-character nodes in the root branch, edited by
index, synced by operation batches.  It is also the workload generator for
BASELINE.json config 1 (flat text buffer replay).

Index-addressed editing maps onto path-addressed CRDT ops:

- ``insert(i, "abc")`` anchors 'a' after the (i-1)-th visible character
  (or the branch-head sentinel for i=0) and chains 'b' after 'a', 'c' after
  'b' — one atomic batch, one timestamp per character.
- ``delete(i, n)`` tombstones the paths of the n visible characters from i.
- Concurrent remote edits merge through ``apply``; RGA placement decides
  interleavings (higher timestamp sits closer to the shared anchor).

Backed by ``engine="tpu"`` (the replica engine; its bulk merges run on
``device``, the card unless the caller names another) or ``"oracle"``
(persistent pure-Python state machine) — identical semantics, pinned by
the reference package's tests/test_text_model.py run on this package and
by tests/test_torch_models.py (each step equal to the reference
model's).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from ..core.operation import Batch, Operation
from .base import ReplicatedModel


class TextBuffer(ReplicatedModel):
    """A replicated text document; see module docstring."""

    def __init__(self, replica: int, engine: str = "tpu", device=None):
        super().__init__(replica, engine, device)
        # visible-path cache, maintained incrementally across LOCAL edits
        # (splice at the edit index) and invalidated by remote merges —
        # keeps per-edit cost O(op), independent of document length
        self._pc: List[Tuple[int, ...]] = []
        self._pc_valid = True

    # -- views ------------------------------------------------------------

    def text(self) -> str:
        return "".join(str(v) for v in self._visible_values())

    def __len__(self) -> int:
        return len(self._visible_paths())

    def _visible_values(self) -> List[str]:
        return self._t.visible_values()

    def _visible_paths(self) -> List[Tuple[int, ...]]:
        if not self._pc_valid:
            if self._engine == "tpu":
                self._pc = self._t.visible_paths()
            else:
                paths: List[Tuple[int, ...]] = []
                self._t.walk(
                    lambda n, acc: ("take", acc.append(n.path) or acc),
                    paths)
                self._pc = paths
            self._pc_valid = True
        return self._pc

    # -- local edits ------------------------------------------------------

    def insert(self, index: int, chunk: str) -> Operation:
        """Insert ``chunk`` before the character at ``index`` (index == len
        appends); returns the delta to broadcast."""
        if not 0 <= index <= len(self):
            raise IndexError(f"insert index {index} out of range")
        if not chunk:
            return Batch(())
        anchor = self._anchor_path(index)

        def first(t):
            return t.add_after(anchor, chunk[0])

        funcs = [first]
        for ch in chunk[1:]:
            funcs.append(lambda t, c=ch: t.add(c))
        self._t = self._t.batch(funcs)
        delta = self._t.last_operation
        if self._pc_valid:
            from ..core.operation import Add
            new_paths = [tuple(op.path[:-1]) + (op.ts,)
                         for op in self._iter_leaves(delta)
                         if isinstance(op, Add)]
            # the RGA rule may have placed the chars further right than the
            # requested index (a right-neighbour with a HIGHER timestamp
            # pulls rank, Internal/Node.elm:93-104) — splice only when the
            # engine confirms each char landed exactly after its intended
            # predecessor, else fall back to a rebuild on next read
            if (self._engine == "tpu"
                    and self._placement_matches(index, new_paths)):
                self._pc[index:index] = new_paths
            else:
                self._pc_valid = False
        return delta

    def _placement_matches(self, index: int,
                           new_paths: List[Tuple[int, ...]]) -> bool:
        """Did the chunk land contiguously at ``index``?  Checks each new
        char's nearest visible predecessor in the mirror — O(chunk·depth)."""
        m = self._t._ensure_mirror()
        expected = self._pc[index - 1] if index > 0 else None
        for p in new_paths:
            slot = m.get_slot(p)
            if slot is None:
                return False
            pred = m.prev_for(slot)
            pred_path = (m.path_of(pred)
                         if pred is not None and not m.tomb[pred] else None)
            if pred_path != expected:
                return False
            expected = p
        return True

    def delete(self, index: int, count: int = 1) -> Operation:
        """Delete ``count`` characters starting at ``index``; returns the
        delta to broadcast."""
        if count < 0 or index < 0 or index + count > len(self):
            raise IndexError(f"delete [{index}, {index + count}) out of "
                             f"range for length {len(self)}")
        doomed = self._visible_paths()[index:index + count]
        self._t = self._t.batch(
            [lambda t, p=p: t.delete(p) for p in doomed])
        del self._pc[index:index + count]
        return self._t.last_operation

    def _anchor_path(self, index: int) -> Sequence[int]:
        if index == 0:
            return (0,)
        return self._visible_paths()[index - 1]

    # -- replication (base class, plus the path-cache invalidation) -------

    @staticmethod
    def _iter_leaves(op: Operation):
        from ..core import operation as op_mod
        return op_mod.iter_leaves(op)

    def apply(self, delta: Operation) -> "TextBuffer":
        """Merge a remote delta (cursor-stable, idempotent)."""
        super().apply(delta)
        self._pc_valid = False          # remote edits land anywhere
        return self
