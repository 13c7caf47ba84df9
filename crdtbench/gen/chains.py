"""Interleaved flat insertion chains (``BASELINE.json`` config 5).

``n_replicas`` replicas each extend their own chain from the branch head
of a flat list (depth 1): a replica's op ``c`` is anchored at its op
``c - 1``, its first op at the head sentinel.  A batch of rows holds
counters ``start + 1 .. start + count`` of every replica, in an order
drawn from the seed that keeps each chain's own order (so every anchor
inside the batch comes before the op that names it).
"""
from __future__ import annotations

import numpy as np

from . import OFFSET, columns, value_table


def chain_rows(rng: np.random.Generator, n_replicas: int, start: int,
               count: int) -> tuple:
    """(columns, values) of counters ``start+1 .. start+count`` of each of
    replicas ``1 .. n_replicas``, seeded interleaving."""
    n = n_replicas * count
    rid = np.repeat(np.arange(1, n_replicas + 1, dtype=np.int64), count)
    counter = np.tile(np.arange(start + 1, start + count + 1,
                                dtype=np.int64), n_replicas)
    # replica-major index j goes to batch row where[j]; keys sorted along
    # each chain keep its counters in order
    keys = np.sort(rng.random((n_replicas, count)), axis=1).ravel()
    order = np.argsort(keys, kind="stable")
    where = np.empty(n, np.int64)
    where[order] = np.arange(n)
    ts = rid * OFFSET + counter
    anchor = np.where(counter == 1, 0, ts - 1)
    prev_in_batch = counter > start + 1
    anchor_pos = np.where(prev_in_batch, where[np.arange(n) - 1], -1)
    cols = columns(n, 1)
    cols["ts"] = ts[order]
    cols["anchor_ts"] = anchor[order]
    cols["paths"][:, 0] = cols["anchor_ts"]
    cols["anchor_pos"] = anchor_pos[order].astype(np.int32)
    return cols, value_table(rng, n)


def delta_order(rng: np.random.Generator, n_sizes: int, steps: int
                ) -> np.ndarray:
    """The catch-up steps' delta indices: one seeded permutation of
    ``range(n_sizes)`` after another, so every ``n_sizes`` steps merge
    each delta once whatever the seed."""
    cycles = -(-steps // n_sizes)
    return np.concatenate([rng.permutation(n_sizes)
                           for _ in range(cycles)])[:steps]
