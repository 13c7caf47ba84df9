"""A nested outline document (``BASELINE.json`` config 3), vectorised
from the port's ``bench/workloads.py`` ``nested_tree``.

Replica 1 first builds a skeleton of ``depth - 1`` nested branches: its
op ``k`` opens a branch at depth ``k`` under the branch of its op
``k - 1``, so the branches are the root's and those ``depth - 1``.
After it, each burst of :data:`BURST` ops comes from a replica and
branch drawn from the seed and appends one chain there: the burst's
first op at the branch head, each further op after the burst's previous
one.  Bursts of different replicas contend at every branch head, at
every depth from 1 to ``depth``.  Rows keep the generation order, burst
after burst, so every anchor and parent inside a batch comes before the
op that names it.
"""
from __future__ import annotations

import numpy as np

from . import OFFSET, columns, value_table

BURST = 64
SKELETON_REPLICA = 1


def branch_paths(depth: int) -> np.ndarray:
    """``[depth, depth - 1]``: row ``L`` holds branch ``L``'s path (the
    skeleton's first ``L`` timestamps; row 0 is the root's, empty),
    zero-padded."""
    skel = SKELETON_REPLICA * OFFSET + np.arange(1, depth, dtype=np.int64)
    lower = np.tril(np.ones((depth, depth - 1), bool), -1)
    return np.where(lower, skel[None, :], 0)


def nested_rows(rng: np.random.Generator, replicas: int, depth: int,
                start_counters, count: int) -> tuple:
    """(columns, values) of ``count`` ops with a ``depth``-wide path
    plane.  ``start_counters[r - 1]`` is replica ``r``'s last counter
    before the batch; a batch from all-zero counters (the document's
    first) begins with the skeleton, and the bursts fill the rest.  A
    later batch continues every replica's counters under the same
    branches (:func:`counters_after` of what came before)."""
    start = np.asarray(start_counters, np.int64)
    fresh = not start.any()
    n_skel = depth - 1 if fresh else 0
    m = count - n_skel
    n_bursts = -(-m // BURST)
    b_rep = rng.integers(1, replicas + 1, n_bursts)
    b_branch = rng.integers(0, depth, n_bursts)
    burst = np.arange(m) // BURST
    first = np.arange(m) % BURST == 0
    rid = b_rep[burst].astype(np.int64)
    level = b_branch[burst]
    # each replica's counters run on in row order
    order = np.argsort(rid, kind="stable")
    sorted_rid = rid[order]
    group = np.searchsorted(sorted_rid, sorted_rid)
    counter = np.empty(m, np.int64)
    counter[order] = np.arange(m) - group + 1
    counter += start[rid - 1]
    if fresh:
        counter[rid == SKELETON_REPLICA] += n_skel
    ts = rid * OFFSET + counter

    n = count
    cols = columns(n, depth)
    paths = branch_paths(depth)
    row = np.arange(n_skel, n)
    anchor = np.where(first, 0, np.roll(ts, 1))
    cols["ts"][n_skel:] = ts
    cols["anchor_ts"][n_skel:] = anchor
    cols["depth"][n_skel:] = level + 1
    cols["paths"][n_skel:, :depth - 1] = paths[level]
    cols["paths"][row, level] = anchor
    cols["parent_ts"][n_skel:] = np.where(
        level > 0, paths[level, np.maximum(level - 1, 0)], 0)
    cols["anchor_pos"][n_skel:] = np.where(first, -1, row - 1)
    if fresh:
        # the skeleton: op k at the head of branch k - 1
        k = np.arange(n_skel)
        cols["ts"][:n_skel] = SKELETON_REPLICA * OFFSET + k + 1
        cols["depth"][:n_skel] = k + 1
        cols["paths"][:n_skel, :depth - 1] = paths[k]
        cols["parent_ts"][:n_skel] = np.where(
            k > 0, paths[k, np.maximum(k - 1, 0)], 0)
        cols["parent_pos"][:n_skel] = k - 1
        cols["parent_pos"][n_skel:] = level - 1
    return cols, value_table(rng, n)


def counters_after(cols: dict, replicas: int) -> np.ndarray:
    """Each replica's last counter in ``cols`` (0 where it sent none)."""
    ts = cols["ts"]
    out = np.zeros(replicas, np.int64)
    np.maximum.at(out, ts // OFFSET - 1, ts % OFFSET)
    return out
