"""The oracle tree kernel: a persistent replicated tree with RGA branches.

This is the sequential correctness oracle for the array engine.  Semantics
follow the reference node kernel (Internal/Node.elm): every branch keeps its
children in a mapping keyed by timestamp, ordered as a singly linked list
threaded through ``nxt`` pointers, with a sentinel tombstone at key ``0``
acting as the list head (Internal/Node.elm:25-48).  Inserting after an anchor
skips right past existing siblings with a larger timestamp — among concurrent
inserts at the same anchor, the higher timestamp sits closer to the anchor
(Internal/Node.elm:93-104).  Deleting replaces a node with a tombstone that
keeps its path and list position but loses value and children
(Internal/Node.elm:112-122, 237-238).

Persistence is by path copying: an update rebuilds only the spine from the
edited branch to the root, sharing everything else — failed operations
therefore never observably mutate the tree, which is what makes local batch
atomicity free (CRDTree.elm:224-232).

Known divergence from the reference, by design: the reference's
``findInsertion`` (Internal/Node.elm:93-104) pairs the *immediate* next
timestamp with the *tombstone-skipping* next node; when a tombstone sits
between siblings those two disagree and an insert then overwrites the
tombstone's mapping slot with a copy of a later sibling, orphaning that
sibling's own key and detaching subsequent deletes from the visible list.
No reference test reaches that state.  We instead treat tombstones as
ordinary members of the sibling chain during the skip-scan — the standard
RGA rule — which reproduces every reference test fixture and keeps the
structure self-consistent under tombstone-heavy workloads (BASELINE config 4).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from .errors import AlreadyApplied, InvalidPath, NotFound

ROOT = 0
NODE = 1
TOMBSTONE = 2


class Node:
    """One tree node.  ``kind`` is ROOT, NODE, or TOMBSTONE.

    - ROOT: only ``children`` is meaningful; path is ``()``.
    - NODE: ``value``, ``children``, ``path`` (full path, last element is the
      node's own timestamp) and ``nxt`` (next sibling timestamp or None).
    - TOMBSTONE: ``path`` and ``nxt`` only; children read as empty
      (Internal/Node.elm:237-238) — a deleted node's descendants are
      discarded.
    """

    __slots__ = ("kind", "value", "_children", "path", "nxt")

    def __init__(self, kind: int, value: Any = None,
                 children: Optional[Dict[int, "Node"]] = None,
                 path: Tuple[int, ...] = (), nxt: Optional[int] = None):
        self.kind = kind
        self.value = value
        self._children = children if children is not None else {}
        self.path = path
        self.nxt = nxt

    # -- construction -----------------------------------------------------

    @staticmethod
    def sentinel(path: Tuple[int, ...] = (), nxt: Optional[int] = None) -> "Node":
        return Node(TOMBSTONE, path=path, nxt=nxt)

    @staticmethod
    def root() -> "Node":
        """Fresh root with the sentinel list head at key 0
        (Internal/Node.elm:41-48)."""
        return Node(ROOT, children={0: Node.sentinel()})

    def _fresh_branch_children(self) -> Dict[int, "Node"]:
        return {0: Node.sentinel()}

    # -- accessors --------------------------------------------------------

    @property
    def children(self) -> Dict[int, "Node"]:
        if self.kind == TOMBSTONE:
            return {}
        return self._children

    def child(self, ts: int) -> Optional["Node"]:
        return self.children.get(ts)

    @property
    def timestamp(self) -> int:
        """Last path element, 0 for the root (Internal/Node.elm:302-308)."""
        return self.path[-1] if self.path else 0

    def get_value(self) -> Any:
        """Value unless deleted or root (Internal/Node.elm:329-339)."""
        return self.value if self.kind == NODE else None

    def is_deleted(self) -> bool:
        return self.kind == TOMBSTONE

    # -- persistent update helpers ---------------------------------------

    def with_children(self, children: Dict[int, "Node"]) -> "Node":
        return Node(self.kind, self.value, children, self.path, self.nxt)

    def with_next(self, nxt: Optional[int]) -> "Node":
        if self.kind == ROOT:
            return self
        return Node(self.kind, self.value, self._children, self.path, nxt)

    def put_child(self, ts: int, node: "Node") -> "Node":
        """Copy of self with ``children[ts] = node``; no-op on tombstones
        (Internal/Node.elm:125-135)."""
        if self.kind == TOMBSTONE:
            return self
        new_children = dict(self._children)
        new_children[ts] = node
        return self.with_children(new_children)


# -- the two mutations ----------------------------------------------------

def add_after(root: Node, path: Sequence[int], ts: int, value: Any) -> Node:
    """Insert ``(ts, value)`` after the node addressed by ``path``.

    ``path[-1]`` is the anchor timestamp within the target branch (0 = branch
    head sentinel); the new node is stamped ``path[:-1] + (ts,)``
    (Internal/Node.elm:51-90).

    Raises AlreadyApplied if ``ts`` already exists in the branch, NotFound if
    the anchor is missing, InvalidPath for empty/broken paths.
    """
    path = tuple(path)

    def edit(anchor_ts: int, parent: Node) -> Node:
        if parent.child(ts) is not None:
            raise AlreadyApplied  # idempotence (Internal/Node.elm:63-65)
        anchor = parent.child(anchor_ts)
        if anchor is None:
            raise NotFound
        # RGA skip-scan: walk right past siblings with larger timestamps;
        # tombstones participate like any other sibling (see module note).
        left_ts, left = anchor_ts, anchor
        while left.nxt is not None and ts < left.nxt:
            left_ts = left.nxt
            left = parent.children[left_ts]
        node = Node(NODE, value, {0: Node.sentinel()},
                    path[:-1] + (ts,), left.nxt)
        return parent.put_child(left_ts, left.with_next(ts)).put_child(ts, node)

    return _update(edit, path, root)


def delete(root: Node, path: Sequence[int]) -> Node:
    """Tombstone the node at ``path``, keeping its list position and path but
    discarding value and children (Internal/Node.elm:107-122).

    Raises NotFound if absent, AlreadyApplied if already a tombstone.
    """
    def edit(target_ts: int, parent: Node) -> Node:
        target = parent.child(target_ts)
        if target is None:
            raise NotFound
        if target.kind != NODE:
            raise AlreadyApplied
        return parent.put_child(target_ts, Node(TOMBSTONE, path=target.path,
                                                nxt=target.nxt))

    return _update(edit, tuple(path), root)


def _update(edit: Callable[[int, Node], Node], path: Tuple[int, ...],
            parent: Node) -> Node:
    """Persistent descent-by-path, rebuilding the spine on the way back up
    (Internal/Node.elm:138-163).

    A tombstone anywhere along the descent raises AlreadyApplied — edits
    under a deleted branch are absorbed as no-ops.
    """
    if parent.kind == TOMBSTONE:
        raise AlreadyApplied
    if not path:
        raise InvalidPath
    if len(path) == 1:
        return edit(path[0], parent)
    head, rest = path[0], path[1:]
    found = parent.child(head)
    if found is None:
        raise InvalidPath
    return parent.put_child(head, _update(edit, rest, found))


# -- traversal ------------------------------------------------------------

def iter_chain(parent: Node) -> Iterator[Node]:
    """All siblings of a branch in list order, tombstones included, sentinel
    excluded."""
    children = parent.children
    cur = children.get(0)
    while cur is not None and cur.nxt is not None:
        cur = children.get(cur.nxt)
        if cur is None:
            return
        yield cur


def iter_visible(parent: Node) -> Iterator[Node]:
    """Visible (non-tombstone) siblings in list order
    (Internal/Node.elm:206-228, 257-268)."""
    for node in iter_chain(parent):
        if node.kind == NODE:
            yield node


def next_node(node: Node, parent: Node) -> Optional[Node]:
    """Next visible sibling after ``node`` (Internal/Node.elm:257-268)."""
    children = parent.children
    cur: Optional[Node] = node
    while cur is not None and cur.nxt is not None:
        cur = children.get(cur.nxt)
        if cur is not None and cur.kind == NODE:
            return cur
    return None


def foldl(func: Callable[[Node, Any], Any], acc: Any, parent: Node) -> Any:
    for node in iter_visible(parent):
        acc = func(node, acc)
    return acc


def foldr(func: Callable[[Node, Any], Any], acc: Any, parent: Node) -> Any:
    for node in reversed(list(iter_visible(parent))):
        acc = func(node, acc)
    return acc


def node_map(func: Callable[[Node], Any], parent: Node) -> List[Any]:
    return [func(n) for n in iter_visible(parent)]


# reference-named alias (CRDTree/Node.elm `map`); node_map stays the
# idiomatic name since `map` shadows the builtin at module scope
map = node_map  # noqa: A001


def filter_map(func: Callable[[Node], Any], parent: Node) -> List[Any]:
    out = []
    for n in iter_visible(parent):
        v = func(n)
        if v is not None:
            out.append(v)
    return out


def find(pred: Callable[[Node], bool], parent: Node) -> Optional[Node]:
    """First chain member matching ``pred`` — tombstones are candidates too:
    the reference's ``findHelp`` follows raw ``next`` pointers without
    skipping (Internal/Node.elm:166-183), which is load-bearing for the
    delete-cursor predecessor search (CRDTree.elm:199-216)."""
    for n in iter_chain(parent):
        if pred(n):
            return n
    return None


def loop(func: Callable[[Node, Any], Any], acc: Any, parent: Node) -> Any:
    """Fold over visible children from the left while the step is "take"
    (CRDTree/Node.elm:136-160).  ``func(node, acc)`` returns ``(step, acc)``
    with step ``"take"`` to continue or ``"done"`` to stop early."""
    for node in iter_visible(parent):
        step, acc = func(node, acc)
        if step == "done":
            return acc
    return acc


def children(parent: Node) -> List[Node]:
    """Visible children in list order (CRDTree/Node.elm:94-98)."""
    return list(iter_visible(parent))


def head(parent: Node) -> Optional[Node]:
    for n in iter_visible(parent):
        return n
    return None


def last(parent: Node) -> Optional[Node]:
    out = None
    for n in iter_visible(parent):
        out = n
    return out


def descendant(node: Node, path: Sequence[int]) -> Optional[Node]:
    """Node at ``path`` below ``node`` (Internal/Node.elm:289-299)."""
    cur: Optional[Node] = node
    if not path:
        return None
    for ts in path:
        if cur is None:
            return None
        cur = cur.child(ts)
    return cur
