"""State carried across between the two packages.

This system's "weights" are data: a packed op batch going in and a
``NodeTable`` coming out.  These functions move both between numpy (what
the JAX package takes and returns on the host) and the port's tensors,
column for column with the dtypes unchanged, so the two packages'
results compare field by field.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .ops.merge import FIELDS, NodeTable


def ops_from_numpy(arrs: Dict, device) -> Dict[str, torch.Tensor]:
    """Packed op columns (numpy arrays or tensors, as
    ``PackedOps.arrays()`` gives them) → tensors on ``device``."""
    out = {}
    for k, v in arrs.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device)
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
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
