"""Operation algebra: the op model every engine in this framework speaks.

``Add(ts, path, value)`` inserts a node with identity ``ts`` *after* the node
addressed by ``path``; the last element of ``path`` is the **anchor** (the
left neighbour's timestamp, ``0`` for the head sentinel of a branch), not the
new node's position.  The new node's own path is ``path[:-1] + (ts,)``.
``Delete(path)`` tombstones the node at ``path``; the operation's timestamp is
the last path element.  ``Batch`` groups operations
(reference: Internal/Operation.elm:17-20, 94-104).

Operations are immutable values.  A replica's full state is reconstructible
from its operation list alone, which is why the TPU engine treats *the op set
itself* as the CRDT state: merge = set union, materialisation = one batched
kernel call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple, Union

from . import timestamp as ts_mod


@dataclasses.dataclass(frozen=True)
class Add:
    """Insert a node with identity ``ts`` after the node at ``path``."""

    ts: int
    path: Tuple[int, ...]
    value: Any

    def __post_init__(self) -> None:
        object.__setattr__(self, "path", tuple(self.path))


@dataclasses.dataclass(frozen=True)
class Delete:
    """Tombstone the node at ``path``."""

    path: Tuple[int, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "path", tuple(self.path))


@dataclasses.dataclass(frozen=True)
class Batch:
    """An ordered group of operations applied atomically when local."""

    ops: Tuple[Operation, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "ops", tuple(self.ops))


Operation = Union[Add, Delete, Batch]


def op_timestamp(op: Operation) -> Optional[int]:
    """Timestamp of an operation (Internal/Operation.elm:94-104).

    A ``Delete``'s timestamp is its target's timestamp (the last path
    element); a ``Batch`` has none.
    """
    if isinstance(op, Add):
        return op.ts
    if isinstance(op, Delete):
        return op.path[-1] if op.path else None
    return None


def op_path(op: Operation) -> Optional[Tuple[int, ...]]:
    """Path of an operation (Internal/Operation.elm:109-119)."""
    if isinstance(op, (Add, Delete)):
        return op.path
    return None


def op_replica_id(op: Operation) -> Optional[int]:
    """Id of the replica that originated the operation."""
    ts = op_timestamp(op)
    return None if ts is None else ts_mod.replica_id(ts)


def to_list(op: Operation) -> list:
    """Flatten one level: a Batch's ops, or the op itself in a singleton list
    (Internal/Operation.elm:58-68)."""
    if isinstance(op, Batch):
        return list(op.ops)
    return [op]


def from_list(ops: Iterable[Operation]) -> Batch:
    """Wrap a list of operations in a Batch (Internal/Operation.elm:73-75)."""
    return Batch(tuple(ops))


def merge(a: Operation, b: Operation) -> Batch:
    """Concatenate two operations into one Batch (Internal/Operation.elm:80-82)."""
    return Batch(tuple(to_list(a) + to_list(b)))


def since(ts: int, operations: list) -> list:
    """Operations at-or-after ``ts`` from a reverse-chronological log.

    Scans the (newest-first) log accumulating ops until it finds the ``Add``
    whose timestamp equals ``ts`` exactly — that Add is *included* in the
    result.  Batch entries are skipped; Deletes never terminate the scan.  If
    no Add matches, returns ``[]`` (Internal/Operation.elm:25-53).  The
    inclusive overlap is deliberate: receivers rely on idempotent re-apply.
    """
    acc: list = []
    for op in operations:
        if isinstance(op, Batch):
            continue
        acc.append(op)
        if isinstance(op, Add) and op.ts == ts:
            acc.reverse()
            return acc
    return []


def count(op: Operation) -> int:
    """Leaf count of an operation, without materializing lazy batches
    (oplog.PackedBatch exposes ``num_leaves``; a plain Batch recurses)."""
    n = getattr(op, "num_leaves", None)
    if n is not None:
        return n
    if isinstance(op, Batch):
        return sum(count(child) for child in op.ops)
    return 1


def iter_leaves(op: Operation) -> Iterator[Operation]:
    """Depth-first iteration over the non-Batch leaves of an operation."""
    if isinstance(op, Batch):
        for child in op.ops:
            yield from iter_leaves(child)
    else:
        yield op
