"""JAX's index rules, written out for PyTorch.

``x[idx]`` in jax.numpy wraps a negative index once and clamps whatever
is still out of range; ``x.at[idx].set(v, mode="drop")`` wraps the same
way and drops the rest.  PyTorch raises on the CPU and device-asserts on
CUDA instead, so every gather and scatter of the port that can meet such
an index goes through these helpers and keeps the reference's answer.
"""
from __future__ import annotations

import torch


def jax_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 row numbers a JAX gather of length-``n`` axis 0 reads."""
    i = idx.long()
    return torch.where(i < 0, i + n, i).clamp_(0, n - 1)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along axis 0 with JAX's wrap-then-clamp rule."""
    return x[jax_index(idx, x.shape[0])]


def _dropped(idx: torch.Tensor, n: int):
    i = idx.long()
    i = torch.where(i < 0, i + n, i)
    return i, (i >= 0) & (i < n)


def set_drop(base: torch.Tensor, idx: torch.Tensor,
             val) -> torch.Tensor:
    """``base.at[idx].set(val, mode="drop")``, for indices that are
    unique among the kept ones (or whose values agree): the write order
    of a duplicated index cannot change the result.  Dropped writes land
    in a scratch row past the end (no boolean mask, so no host sync on
    the card).  Returns a new tensor."""
    n = base.shape[0]
    i, keep = _dropped(idx, n)
    ext = torch.cat([base, base[:1]])
    if isinstance(val, torch.Tensor):
        val = val.to(base.dtype)
    ext[torch.where(keep, i, n)] = val
    return ext[:n]


def min_drop(base: torch.Tensor, idx: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].min(val, mode="drop")``: a scatter-min, exact under
    any write order."""
    n = base.shape[0]
    i, keep = _dropped(idx, n)
    ext = torch.cat([base, base[:1]])        # row n takes the dropped
    ext.scatter_reduce_(0, torch.where(keep, i, n), val.to(base.dtype),
                        "amin", include_self=True)
    return ext[:n]


def max_drop(base: torch.Tensor, idx: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].max(val, mode="drop")``: a scatter-max, exact under
    any write order."""
    n = base.shape[0]
    i, keep = _dropped(idx, n)
    ext = torch.cat([base, base[:1]])        # row n takes the dropped
    ext.scatter_reduce_(0, torch.where(keep, i, n), val.to(base.dtype),
                        "amax", include_self=True)
    return ext[:n]


def add_drop(n: int, idx: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """``zeros(n).at[idx].add(1, mode="drop")``: counts per index."""
    i, keep = _dropped(idx, n)
    out = torch.zeros(n + 1, dtype=dtype, device=idx.device)
    out.index_add_(0, torch.where(keep, i, n),
                   torch.ones_like(i, dtype=dtype))
    return out[:n]
