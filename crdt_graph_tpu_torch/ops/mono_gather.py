"""The run-to-token rank expansion (merge stage 6).

``monotone_gather(values, rid)`` is ``values[:, rid]`` for i32
``values[V, R]`` and i32 ``rid[T]``; in the merge ``rid`` is the
nondecreasing run id of each enter token.  On CUDA tensors it runs
``csrc/mono_gather.cu`` (the port of the reference's Pallas
``mono_gather._kernel``), which takes any ``rid``; on CPU tensors its
plain twin (the reference's ``_lax_gather``, JAX's index clamp
included).
"""
from __future__ import annotations

import torch

from .. import kernels
from ..kernels import build
from ..utils import chainaudit
from .indexing import jax_index


def plain_gather(values: torch.Tensor, rid: torch.Tensor) -> torch.Tensor:
    """Twin: ``values[:, rid]`` with JAX's wrap-then-clamp."""
    return values[:, jax_index(rid, values.shape[1])]


@chainaudit.kernel_call
def monotone_gather(values: torch.Tensor, rid: torch.Tensor) -> torch.Tensor:
    """``values[:, rid]``: the CUDA kernel on CUDA tensors, the twin on
    CPU tensors; any other device, and arguments the kernel does not
    take, raise ``ValueError`` on either."""
    dev = values.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if values.dtype != torch.int32 or values.dim() != 2 or \
            not values.is_contiguous() or values.shape[0] < 1 or \
            values.shape[1] < 1:
        raise ValueError("values must be a contiguous non-empty int32 [V, R]")
    if rid.dtype != torch.int32 or rid.dim() != 1 or \
            not rid.is_contiguous() or rid.device != dev:
        raise ValueError("rid must be a contiguous int32 [T] on the "
                         "values' device")
    if dev.type == "cpu":
        return plain_gather(values, rid)
    v, r = values.shape
    t = rid.shape[0]
    out = torch.empty((v, t), dtype=torch.int32, device=dev)
    if t:
        build.check(build.load().crdt_monotone_gather(
            values.data_ptr(), v, r, rid.data_ptr(), t, out.data_ptr(),
            build.stream_ptr(dev)), "crdt_monotone_gather")
        kernels.launches["monotone_gather"] += 1
    return out
