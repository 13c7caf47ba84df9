"""State carried across between the two packages.

This system's "weights" are data: a packed op batch going in and a
``NodeTable`` coming out, and a replica's state (its op log, clocks and
cursor).  These functions move them between numpy (what the JAX package
takes and returns on the host) and the port's tensors, column for column
with the dtypes unchanged, so the two packages' results compare field by
field.  A replica's binary checkpoint (``engine.write_packed_npz``) is
the same file in both packages and restores in either.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .ops.merge import FIELDS, NodeTable
from .utils import profiling


def ops_from_numpy(arrs: Dict, device) -> Dict[str, torch.Tensor]:
    """Packed op columns (numpy arrays or tensors, as
    ``PackedOps.arrays()`` gives them, or a batch's ``[B, N]`` columns,
    as ``parallel.mesh.stack_packed`` stacks them) → tensors on
    ``device``, shapes and dtypes unchanged.  While a profiler records,
    the bytes of the numpy columns handed to ``.to(device)`` add to the
    count ``convert.h2d_bytes`` of the innermost open span
    (``utils.profiling.count``), whatever the device: on the CPU nothing
    crosses, yet the same bytes are counted."""
    out = {}
    sent = 0
    for k, v in arrs.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device)
        else:
            v = np.ascontiguousarray(v)
            sent += v.nbytes
            out[k] = torch.from_numpy(v).to(device)
    profiling.count("convert.h2d_bytes", sent)
    return out


def table_to_numpy(t: NodeTable) -> Dict[str, np.ndarray]:
    """A ``NodeTable`` → ``{field: numpy array}`` (one copy per field)."""
    return {f: getattr(t, f).cpu().numpy() for f in FIELDS}


def table_from_numpy(d, device) -> NodeTable:
    """``{field: array}`` or any object with the table's fields (e.g. the
    JAX package's ``NodeTable``) → a ``NodeTable`` of tensors."""
    get = d.__getitem__ if isinstance(d, dict) else \
        (lambda f: getattr(d, f))
    return NodeTable(**{
        f: torch.from_numpy(np.array(get(f))).to(device) for f in FIELDS})


LOG_COLS = ("kind", "ts", "parent_ts", "anchor_ts", "depth", "paths",
            "value_ref", "pos", "parent_pos", "anchor_pos", "target_pos",
            "ts_rank")


def replica_state_to_numpy(tree) -> Dict[str, Any]:
    """A replica engine's state as numpy arrays and plain values: clocks,
    cursor, the applied log's packed columns (its real rows), its value
    table and the last apply's applied mask.  Reads only the engine's
    public surface, so it takes a replica of either package."""
    p = tree.packed_state()
    n = p.num_ops
    out: Dict[str, Any] = {
        "replica": int(tree.replica_id),
        "timestamp": int(tree.timestamp),
        "cursor": tuple(int(c) for c in tree.cursor),
        "clocks": {int(r): int(tree.last_replica_timestamp(r))
                   for r in np.unique(p.ts[:n] >> 32).tolist()},
        "log_length": int(tree.log_length),
        "values": list(p.values),
        "last_applied_mask": (None if tree.last_applied_mask is None else
                              np.asarray(tree.last_applied_mask, bool)),
    }
    for k in LOG_COLS:
        out["log_" + k] = np.asarray(getattr(p, k))[:n]
    return out
