"""The replica state machine: a persistent CRDTree value.

Semantics mirror the reference replica layer (CRDTree.elm).  A ``CRDTree``
holds the tree root, the replica clock, a local cursor, the reverse-
chronological operation log, a vector clock of per-replica last-seen
timestamps, and the last successfully applied operation (for broadcasting)
(CRDTree.elm:112-139).

All methods are pure: they return a new ``CRDTree`` and never mutate the
receiver; failures raise and leave every previously obtained value intact.
Local batches are atomic — the first failing step aborts the whole batch
(CRDTree.elm:224-232, tests/CRDTreeTest.elm:482-498) — which falls out of
persistence for free.

Idempotence contract: an operation that already took effect (duplicate add,
repeated delete, edit under a deleted branch) is absorbed as a success-no-op
with ``last_operation`` reset to an empty batch (CRDTree.elm:318-319).
Duplicate delivery is normal in this protocol; receivers must absorb the
inclusive overlap of ``operations_since`` (CRDTree.elm:390-418).
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple

from . import node as node_mod
from . import operation as op_mod
from . import timestamp as ts_mod
from .errors import (AlreadyApplied, CRDTError, InvalidPath, InvalidPathError,
                     NotFound, OperationFailedError)
from .node import Node
from .operation import Add, Batch, Delete, Operation

# Steps for the resumable `walk` fold (CRDTree/Node.elm:80-85).
DONE = "done"
TAKE = "take"


class CRDTree:
    """A replicated tree value.  Construct with :func:`init`."""

    __slots__ = ("root", "timestamp", "cursor", "operations", "replicas",
                 "last_operation")

    def __init__(self, root: Node, timestamp: int, cursor: Tuple[int, ...],
                 operations: Tuple[Operation, ...], replicas: dict,
                 last_operation: Operation):
        self.root = root
        self.timestamp = timestamp
        self.cursor = cursor
        self.operations = operations  # newest first
        self.replicas = replicas
        self.last_operation = last_operation

    # -- construction -----------------------------------------------------

    @staticmethod
    def init(replica: int) -> "CRDTree":
        """Fresh replica with clock ``replica * 2**32`` (CRDTree.elm:130-139)."""
        return CRDTree(root=Node.root(),
                       timestamp=ts_mod.make(replica, 0),
                       cursor=(0,),
                       operations=(),
                       replicas={},
                       last_operation=Batch(()))

    def _replace(self, **kw) -> "CRDTree":
        fields = {s: getattr(self, s) for s in CRDTree.__slots__}
        fields.update(kw)
        return CRDTree(**fields)

    # -- identity ---------------------------------------------------------

    @property
    def replica_id(self) -> int:
        return ts_mod.replica_id(self.timestamp)

    @property
    def id(self) -> int:
        """Reference-named alias of :attr:`replica_id` (CRDTree.elm `id`)."""
        return self.replica_id

    def next_timestamp(self) -> int:
        return self.timestamp + 1

    def last_replica_timestamp(self, replica: int) -> int:
        """Last seen timestamp for a replica, 0 if never seen
        (CRDTree.elm:637-639)."""
        return self.replicas.get(replica, 0)

    # -- local edits ------------------------------------------------------

    def add(self, value: Any) -> "CRDTree":
        """Add a node after the cursor (CRDTree.elm:151-153)."""
        return self.add_after(self.cursor, value)

    def add_after(self, path: Sequence[int], value: Any) -> "CRDTree":
        """Add a node after the node at ``path``, stamped with the next local
        timestamp (CRDTree.elm:166-168)."""
        return self._apply_local(Add(self.next_timestamp(), tuple(path), value))

    def add_branch(self, value: Any) -> "CRDTree":
        """Add a node and descend the cursor into it so subsequent adds nest
        (CRDTree.elm:180-186)."""
        tree = self.add(value)
        return tree._replace(cursor=tree.cursor + (0,))

    def delete(self, path: Sequence[int]) -> "CRDTree":
        """Tombstone the node at ``path`` and move the cursor to its
        predecessor (CRDTree.elm:199-216)."""
        path = tuple(path)
        target = self.get(path)
        parent = self._parent_or_root(target) if target is not None else self.root
        prev = node_mod.find(
            lambda n: self.next(n) is target, parent) if parent else None
        path_previous = prev.path if prev is not None else path
        tree = self._apply_local(Delete(path))
        return tree.set_cursor(path_previous)

    def batch(self, funcs: Iterable[Callable[["CRDTree"], "CRDTree"]]
              ) -> "CRDTree":
        """Apply a sequence of edit functions atomically, accumulating their
        last-operations into one Batch (CRDTree.elm:224-232)."""
        tree = self._replace(last_operation=Batch(()))
        for func in funcs:
            prev_last = tree.last_operation
            tree = func(tree)
            tree = tree._replace(
                last_operation=op_mod.merge(prev_last, tree.last_operation))
        return tree

    # -- remote application ----------------------------------------------

    def apply(self, operation: Operation) -> "CRDTree":
        """Apply a remote operation; the local cursor does not move
        (CRDTree.elm:265-269)."""
        saved = self.cursor
        tree = self._apply_local(operation)
        return tree._replace(cursor=saved)

    def _apply_local(self, operation: Operation) -> "CRDTree":
        """Dispatch one operation into the node kernel and commit
        (CRDTree.elm:275-295)."""
        if isinstance(operation, Add):
            result = self._edit(
                lambda: node_mod.add_after(self.root, operation.path,
                                           operation.ts, operation.value),
                operation, operation.path, operation.ts)
            return result._increment_timestamp(operation.ts)
        if isinstance(operation, Delete):
            ts = op_mod.op_timestamp(operation) or 0
            return self._edit(
                lambda: node_mod.delete(self.root, operation.path),
                operation, operation.path, ts)
        # Batch: each member applied with cursor-restoring `apply`
        # (CRDTree.elm:294-295).
        return self.batch([(lambda op: lambda t: t.apply(op))(op)
                           for op in operation.ops])

    def _edit(self, thunk: Callable[[], Node], operation: Operation,
              path: Tuple[int, ...], ts: int) -> "CRDTree":
        """Run a node edit and commit the result (CRDTree.elm:298-325)."""
        try:
            new_root = thunk()
        except AlreadyApplied:
            # Success-no-op; nothing logged, nothing broadcast.
            return self._replace(last_operation=Batch(()))
        except InvalidPath:
            raise InvalidPathError(f"invalid path {path!r}")
        except NotFound:
            raise OperationFailedError(operation)
        new_replicas = dict(self.replicas)
        new_replicas[ts_mod.replica_id(ts)] = ts
        return self._replace(
            root=new_root,
            cursor=tuple(path[:-1]) + (ts,),
            operations=(operation,) + self.operations,
            last_operation=operation,
            replicas=new_replicas)

    def _increment_timestamp(self, ts: int) -> "CRDTree":
        """Advance the clock only for operations this replica originated
        (CRDTree.elm:337-343)."""
        if ts_mod.replica_id(ts) == self.replica_id:
            return self._replace(timestamp=self.next_timestamp())
        return self

    # -- anti-entropy -----------------------------------------------------

    def operations_since(self, initial_timestamp: int) -> Operation:
        """Batch of operations at-or-after a timestamp; 0 replays the full
        log chronologically (CRDTree.elm:408-418).  The match is inclusive —
        receivers absorb the overlap idempotently."""
        if initial_timestamp == 0:
            return op_mod.from_list(tuple(reversed(self.operations)))
        return op_mod.from_list(
            op_mod.since(initial_timestamp, list(self.operations)))

    # -- queries ----------------------------------------------------------

    def get(self, path: Sequence[int]) -> Optional[Node]:
        """Node at ``path`` (tombstones included) or None (CRDTree.elm:464-466)."""
        return node_mod.descendant(self.root, tuple(path))

    def get_value(self, path: Sequence[int]) -> Any:
        """Value at ``path``; None for missing/deleted nodes
        (CRDTree.elm:486-488)."""
        found = self.get(path)
        return found.get_value() if found is not None else None

    def parent(self, node: Node) -> Optional[Node]:
        """Parent of a node; the root for depth-1 nodes (CRDTree.elm:430-444)."""
        parent_path = node.path[:-1]
        if not parent_path:
            return self.root
        return self.get(parent_path)

    def _parent_or_root(self, node: Optional[Node]) -> Optional[Node]:
        if node is None:
            return self.root
        parent = self.parent(node)
        return parent if parent is not None else self.root

    def next(self, node: Node) -> Optional[Node]:
        """Next visible sibling (CRDTree.elm:563-568)."""
        parent = self.parent(node)
        if parent is None:
            return None
        return node_mod.next_node(node, parent)

    def prev(self, node: Node) -> Optional[Node]:
        """Previous visible sibling (CRDTree.elm:573-577)."""
        parent = self.parent(node)
        if parent is None:
            return None
        return node_mod.find(lambda n: self.next(n) is node, parent)

    def walk(self, func: Callable[[Node, Any], Tuple[str, Any]], acc: Any,
             start: Optional[Node] = None) -> Any:
        """Resumable depth-first fold over visible nodes in document order
        (CRDTree.elm:583-625).

        ``func(node, acc)`` returns ``(TAKE, acc)`` to continue (descending
        into the node's children) or ``(DONE, acc)`` to stop.  ``start`` is
        exclusive: the walk resumes *after* it, covering the remainder of its
        sibling list (with full descents); ``start=None`` walks the whole
        tree.  The reference's ``walk`` is untested (CRDTree.elm:585 "TODO:
        no tests") and as written skips the first node of every visited
        branch; we implement the self-consistent resumable reading instead.
        """
        if start is None:
            _, acc = self._walk_children(func, acc, self.root)
            return acc
        parent = self.parent(start)
        if parent is None:
            return acc
        node = node_mod.next_node(start, parent)
        while node is not None:
            step, acc = func(node, acc)
            if step == DONE:
                return acc
            done, acc = self._walk_children(func, acc, node)
            if done:
                return acc
            node = node_mod.next_node(node, parent)
        return acc

    def _walk_children(self, func, acc, branch: Node):
        for child in node_mod.iter_visible(branch):
            step, acc = func(child, acc)
            if step == DONE:
                return True, acc
            done, acc = self._walk_children(func, acc, child)
            if done:
                return True, acc
        return False, acc

    # -- cursor -----------------------------------------------------------

    def move_cursor_up(self) -> "CRDTree":
        """Truncate the cursor one level (CRDTree.elm:537-543)."""
        if len(self.cursor) == 1:
            return self
        return self._replace(cursor=self.cursor[:-1])

    def set_cursor(self, path: Sequence[int]) -> "CRDTree":
        """Point the cursor at an existing node (CRDTree.elm:551-558)."""
        path = tuple(path)
        if self.get(path) is None:
            raise NotFound(f"no node at {path!r}")
        return self._replace(cursor=path)

    # -- convenience ------------------------------------------------------

    def visible_values(self) -> List[Any]:
        """Values of all visible nodes in document order — the render path."""
        out: List[Any] = []
        self.walk(lambda n, acc: (TAKE, acc.append(n.get_value()) or acc), out)
        return out

    def __repr__(self) -> str:
        return (f"CRDTree(replica={self.replica_id}, "
                f"ops={len(self.operations)}, ts={self.timestamp})")


def init(replica: int) -> CRDTree:
    """Build a CRDTree for a replica id (CRDTree.elm:130-139)."""
    return CRDTree.init(replica)
