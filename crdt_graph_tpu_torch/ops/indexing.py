"""JAX's index rules, written out for PyTorch.

``x[idx]`` in jax.numpy wraps a negative index once and clamps whatever
is still out of range; ``x.at[idx].set(v, mode="drop")`` wraps the same
way and drops the rest.  The scatters work along the last axis, so a
leading document axis (the batched merge) keeps each document's writes
in its own row.  PyTorch raises on the CPU and device-asserts on
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


def _scatter_src(val, like: torch.Tensor, dtype):
    """``val`` as a scatter source of ``like``'s shape: a tensor cast and
    broadcast (a view), a Python scalar as it is."""
    if isinstance(val, torch.Tensor):
        return val.to(dtype).expand(like.shape)
    return val


def set_drop(base: torch.Tensor, idx: torch.Tensor,
             val) -> torch.Tensor:
    """``base.at[idx].set(val, mode="drop")`` along the last axis (each
    leading index, a document, on its own), for indices that are unique
    among the kept ones (or whose values agree): the write order of a
    duplicated index cannot change the result.  Dropped writes land in a
    scratch column past the end (no boolean mask, so no host sync on the
    card).  Returns a new tensor."""
    n = base.shape[-1]
    i, keep = _dropped(idx, n)
    ext = torch.cat([base, base[..., :1]], -1)
    tgt = torch.where(keep, i, n)
    ext.scatter_(-1, tgt, _scatter_src(val, tgt, base.dtype))
    return ext[..., :n]


def _reduce_drop(base: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                 how: str) -> torch.Tensor:
    n = base.shape[-1]
    i, keep = _dropped(idx, n)
    ext = torch.cat([base, base[..., :1]], -1)  # column n takes the dropped
    tgt = torch.where(keep, i, n)
    ext.scatter_reduce_(-1, tgt, _scatter_src(val, tgt, base.dtype), how,
                        include_self=True)
    return ext[..., :n]


def min_drop(base: torch.Tensor, idx: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].min(val, mode="drop")`` along the last axis: a
    scatter-min, exact under any write order."""
    return _reduce_drop(base, idx, val, "amin")


def max_drop(base: torch.Tensor, idx: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].max(val, mode="drop")`` along the last axis: a
    scatter-max, exact under any write order."""
    return _reduce_drop(base, idx, val, "amax")


def add_drop(n: int, idx: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """``zeros(n).at[idx].add(1, mode="drop")`` along the last axis:
    counts per index."""
    i, keep = _dropped(idx, n)
    out = torch.zeros(idx.shape[:-1] + (n + 1,), dtype=dtype,
                      device=idx.device)
    out.scatter_add_(-1, torch.where(keep, i, n),
                     torch.ones_like(i, dtype=dtype))
    return out[..., :n]
