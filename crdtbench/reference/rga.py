"""The plain reference: the converged tree of a set of Add operations,
worked out from the op columns alone, in NumPy and plain Python.

It states the replicated tree's rules directly, with none of the
program's machinery (no hints, no slots, no Euler tour, no list
ranking), and imports nothing of the program:

- An ``Add`` with path ``(p_1, ..., p_k, a)`` inserts node ``ts`` into
  the branch of node ``p_k`` (the root's branch when ``k = 0``), right
  after its sibling ``a`` (``a = 0``: at the branch head).  Its own path
  is ``(p_1, ..., p_k, ts)``; the claimed prefix must be its parent's
  path, and the anchor a node of the same branch.
- The set is a semilattice: the first row of a timestamp is the node,
  later rows of it are absorbed.
- Within a branch the converged order is RGA's: repeatedly emit the
  largest-timestamp node whose anchor has been emitted (the greedy
  linearisation the sequential skip-scan converges to, whatever the
  delivery order).
- The document order is a node, then its own branch, then the rest of
  the branch it sits in.

Per-op statuses follow sequential application of a causally ordered
batch: ``APPLIED`` for a node that joins the tree, ``ALREADY_APPLIED``
for a repeated timestamp, ``INVALID_PATH`` for a missing parent or a
prefix that is not the parent's path, ``NOT_FOUND`` for an anchor that
is not in the branch.  Deletes are outside what the benchmark's
configurations send, and raise.

``sibling_rule="arrival"`` is the control: concurrent siblings in the
order they arrived instead of by timestamp, which breaks convergence
(two replicas that received the same ops in another order disagree).
"""
from __future__ import annotations

import heapq

import numpy as np

APPLIED, ALREADY_APPLIED, NOT_FOUND, INVALID_PATH = 0, 1, 2, 3
KIND_ADD = 0


def converge(kind, ts, depth, paths, n: int,
             sibling_rule: str = "timestamp") -> dict:
    """The converged tree of rows ``[0, n)``: ``order_ts`` (node
    timestamps in document order), ``order_depth``, ``order_parent_ts``
    (0 under the root) and ``status`` (int8 per row)."""
    kind = np.asarray(kind[:n])
    ts = np.asarray(ts[:n], np.int64)
    depth = np.asarray(depth[:n], np.int64)
    paths = np.asarray(paths[:n], np.int64)
    if np.any(kind != KIND_ADD):
        raise NotImplementedError("the reference covers Add operations")
    if np.any(depth < 1) or np.any(depth > paths.shape[1]):
        raise ValueError("depth outside the path plane")
    status = np.full(n, INVALID_PATH, np.int8)

    # nodes: the first row of each timestamp, indexed in timestamp order
    uts, first = np.unique(ts, return_index=True)
    u = uts.size
    dup = np.ones(n, bool)
    dup[first] = False
    status[dup] = ALREADY_APPLIED
    rows = first
    d = depth[rows]
    rp = paths[rows]
    anchor = rp[np.arange(u), d - 1]
    parent_ts = np.where(d >= 2, rp[np.arange(u), np.maximum(d - 2, 0)], 0)

    def node_of(t):
        i = np.minimum(np.searchsorted(uts, t), u - 1)
        return np.where((t != 0) & (uts[i] == t), i, -1)

    parent = node_of(parent_ts)          # -1: the root (or missing)
    anc = node_of(anchor)
    # the claimed prefix is the parent's own path: parent depth d - 1,
    # parent's claimed prefix equal, and the parent's timestamp next
    ok_parent = (d == 1) | (parent >= 0)
    pp = np.maximum(parent, 0)
    width = paths.shape[1]
    col = np.arange(width)[None, :]
    mine = np.where(col < (d - 2)[:, None], rp, 0)
    theirs = np.where(col < (d[pp] - 1)[:, None], rp[pp], 0)
    prefix_ok = (d == 1) | ((d[pp] == d - 1) & np.all(mine == theirs, 1))
    path_ok = ok_parent & prefix_ok
    anchor_ok = (anchor == 0) | ((anc >= 0) & (parent[np.maximum(anc, 0)]
                                               == parent))

    # anchor-children of every node, and of every branch head (key
    # u + p for node p's branch, 2u for the root's), rank-ordered
    key = np.where(anchor == 0, np.where(parent >= 0, u + parent, 2 * u),
                   anc)
    cand = np.nonzero(path_ok & anchor_ok)[0]
    if sibling_rule == "timestamp":
        rank = -cand                       # larger timestamp first
    elif sibling_rule == "arrival":
        rank = rows[cand]                  # earlier row first
    else:
        raise ValueError(sibling_rule)
    srt = cand[np.lexsort((rank, key[cand]))]
    start = np.searchsorted(key[srt], np.arange(2 * u + 2)).tolist()
    prio = np.empty(u, np.int64)
    prio[cand] = rank
    pr = prio.tolist()
    ch = srt.tolist()

    out = []
    stack = [[(pr[c], c) for c in ch[start[2 * u]:start[2 * u + 1]]]]
    heapq.heapify(stack[0])
    push, pop, emit = heapq.heappush, heapq.heappop, out.append
    while stack:
        h = stack[-1]
        if not h:
            stack.pop()
            continue
        x = pop(h)[1]
        while True:
            emit(x)
            a, b = start[x], start[x + 1]
            own_a, own_b = start[u + x], start[u + x + 1]
            if b - a == 1 and own_a == own_b:
                # a chain link: its one successor goes next unless a
                # waiting sibling outranks it
                c = ch[a]
                if not h or pr[c] < h[0][0]:
                    x = c
                    continue
            for c in ch[a:b]:
                push(h, (pr[c], c))
            if own_a < own_b:
                hb = [(pr[c], c) for c in ch[own_a:own_b]]
                heapq.heapify(hb)
                stack.append(hb)
            break

    order = np.asarray(out, np.int64)
    reached = np.zeros(u, bool)
    reached[order] = True
    st = np.where(reached, APPLIED,
                  np.where(path_ok & (parent_ok_reached(parent, reached)),
                           NOT_FOUND, INVALID_PATH))
    status[rows] = st
    return {"order_ts": uts[order],
            "order_depth": d[order],
            "order_parent_ts": np.where(parent[order] >= 0,
                                        uts[np.maximum(parent[order], 0)],
                                        0),
            "status": status}


def parent_ok_reached(parent: np.ndarray, reached: np.ndarray
                      ) -> np.ndarray:
    """True where the node's parent (or the root) joined the tree."""
    return (parent < 0) | reached[np.maximum(parent, 0)]
