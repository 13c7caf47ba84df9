"""Host-side readers for a NodeTable.

The merge never touches payloads; these helpers join the table back with
the host value table to produce what applications consume (visible value
sequences, node listings, per-op statuses).  They read numpy fields, so
call :func:`to_host` once on a table that lives on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np

from .merge import ALREADY_APPLIED, APPLIED, FIELDS, INVALID_PATH, \
    NOT_FOUND, PAD, NodeTable

STATUS_NAMES = {APPLIED: "applied", ALREADY_APPLIED: "already_applied",
                NOT_FOUND: "not_found", INVALID_PATH: "invalid_path",
                PAD: "pad"}


def to_host(table: NodeTable) -> NodeTable:
    """A table of tensors → the same table of numpy arrays."""
    return dataclasses.replace(
        table, **{f: getattr(table, f).cpu().numpy() for f in FIELDS})


def visible_slots(table: NodeTable) -> np.ndarray:
    return np.asarray(table.visible_order)[:int(table.num_visible)]


def visible_values(table: NodeTable, values: Sequence[Any]) -> List[Any]:
    """Values of visible nodes in document order (the render path)."""
    refs = np.asarray(table.value_ref)
    return [values[refs[s]] for s in visible_slots(table)]


def visible_paths(table: NodeTable) -> List[tuple]:
    paths = np.asarray(table.paths)
    depths = np.asarray(table.depth)
    return [tuple(int(x) for x in paths[s, :depths[s]])
            for s in visible_slots(table)]


def statuses(table: NodeTable, num_ops: Optional[int] = None) -> List[str]:
    st = np.asarray(table.status)
    if num_ops is not None:
        st = st[:num_ops]
    return [STATUS_NAMES[int(s)] for s in st]


def get_value(table: NodeTable, values: Sequence[Any],
              path: Sequence[int]) -> Any:
    """Value at a timestamp path; None for missing/deleted/dead nodes."""
    path = tuple(path)
    d = len(path)
    paths = np.asarray(table.paths)
    if d == 0 or d > paths.shape[1]:
        return None
    hit = np.nonzero(
        np.asarray(table.visible) & (np.asarray(table.depth) == d) &
        np.all(paths[:, :d] == np.asarray(path, dtype=np.int64), axis=1))[0]
    if hit.size == 0:
        return None
    return values[int(np.asarray(table.value_ref)[hit[0]])]
