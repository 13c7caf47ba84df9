"""Replicated outline: a nested-document model over the tree CRDT.

The reference is a generic replicated TREE (branches of RGAs), not just a
flat text rope — this model exercises that nesting surface the way the
companion editor exercises the flat one (models/text.py): an outline /
todo document whose items form a tree, edited concurrently and merged
through operation batches.

- ``add_item(text, parent=…, after=…)`` places an item into a branch:
  anchored after the sibling ``after`` when given, else at the HEAD of
  ``parent``'s branch (so repeated head-adds stack newest-first, the
  RGA rule; pass ``after`` to append in reading order).
- ``add_section(text, …)`` adds an item that nests: later items can be
  placed under it (its children form their own RGA).
- ``delete_item(path)`` removes an item AND its whole subtree
  (tombstone semantics: a deleted branch discards its descendants,
  Internal/Node.elm:237-238).
- ``items()`` / ``render()`` walk visible items in document order with
  their depth — the render path of an outline editor.

Works over either engine (``"tpu"``: the replica engine on ``device``,
the card unless the caller names another; ``"oracle"``: the persistent
state machine) with identical semantics, pinned by the reference
package's tests/test_outline_model.py run on this package and by
tests/test_torch_models.py (each step equal to the reference model's).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..core import operation as op_mod
from ..core.operation import Operation
from .base import ReplicatedModel


class OutlineDoc(ReplicatedModel):
    """A replicated outline document; see module docstring."""

    # -- local edits ------------------------------------------------------

    def add_item(self, text: str,
                 parent: Optional[Sequence[int]] = None,
                 after: Optional[Sequence[int]] = None
                 ) -> Optional[Tuple[int, ...]]:
        """Add an item; returns its path, or None when the add was
        absorbed as a success-no-op (the anchor's branch was deleted — a
        concurrent delete won; the reference treats edits under deleted
        branches as silent no-ops, CRDTree.elm:318-319).

        ``after`` anchors behind an existing sibling (its path);
        otherwise the item lands at the head of ``parent``'s branch
        (root branch when ``parent`` is None).  Concurrent same-anchor
        adds resolve by the RGA rule (higher timestamp nearer the
        anchor)."""
        anchor = (tuple(after) if after is not None
                  else (*(tuple(parent) if parent else ()), 0))
        self._t = self._t.add_after(anchor, text)
        applied = op_mod.to_list(self._t.last_operation)
        if not applied:
            return None
        op = applied[0]
        return tuple(op.path[:-1]) + (op.ts,)

    def add_section(self, text: str,
                    parent: Optional[Sequence[int]] = None,
                    after: Optional[Sequence[int]] = None
                    ) -> Optional[Tuple[int, ...]]:
        """An item intended to hold children; structurally identical to
        :meth:`add_item` (any node can grow a branch) — provided for
        intent at call sites."""
        return self.add_item(text, parent=parent, after=after)

    def delete_item(self, path: Sequence[int]) -> Operation:
        """Tombstone the item; its subtree leaves the document."""
        self._t = self._t.delete(tuple(path))
        return self._t.last_operation

    # -- views ------------------------------------------------------------

    def items(self) -> List[Tuple[int, str, Tuple[int, ...]]]:
        """Visible items in document order as (depth, text, path)."""
        out: List[Tuple[int, str, Tuple[int, ...]]] = []

        def visit(node, acc):
            acc.append((len(node.path), node.value, tuple(node.path)))
            return ("take", acc)

        self._t.walk(visit, out)
        return out

    def render(self, indent: str = "  ") -> str:
        """Indented text rendering (depth-1 items flush left)."""
        return "\n".join(f"{indent * (d - 1)}{text}"
                         for d, text, _ in self.items())

    def __len__(self) -> int:
        return len(self.items())
