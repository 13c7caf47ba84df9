"""Seeded, vectorised op-column generators (copied and reworked from the
port's ``bench/workloads.py``: ``chain_workload``).

Every generator returns plain NumPy op columns in the packed layout
(``kind``, ``ts``, ``parent_ts``, ``anchor_ts``, ``depth``, ``paths``,
``value_ref``, ``pos`` and the link hints ``parent_pos``, ``anchor_pos``,
``target_pos``) plus a value table, from a ``numpy.random.Generator``.
The same seed gives the same columns; a different seed gives the same
sizes in another order.
"""
from __future__ import annotations

import numpy as np

OFFSET = 2**32          # ts = replica * 2**32 + counter
KIND_ADD = 0


def columns(n: int, width: int) -> dict:
    """Empty add columns for ``n`` rows with a ``width``-wide path plane."""
    return {
        "kind": np.full(n, KIND_ADD, np.int8),
        "ts": np.zeros(n, np.int64),
        "parent_ts": np.zeros(n, np.int64),
        "anchor_ts": np.zeros(n, np.int64),
        "depth": np.ones(n, np.int32),
        "paths": np.zeros((n, width), np.int64),
        "value_ref": np.arange(n, dtype=np.int32),
        "pos": np.arange(n, dtype=np.int32),
        "parent_pos": np.full(n, -1, np.int32),
        "anchor_pos": np.full(n, -1, np.int32),
        "target_pos": np.full(n, -1, np.int32),
    }


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one named stream of a run's seed (any whole
    number; negative and 64-bit seeds are folded in whole)."""
    return np.random.default_rng([abs(int(seed)) % (2**63),
                                  int(seed < 0), *stream])


def value_table(rng: np.random.Generator, n: int) -> list:
    """``n`` seeded payloads (small ints, as an editor's characters)."""
    return rng.integers(32, 127, n).tolist()
