"""The run-to-token rank expansion (merge stage 6).

``monotone_gather(values, rid)`` is ``values[:, rid]`` for i32
``values[V, R]`` and i32 ``rid[T]``; in the merge ``rid`` is the
nondecreasing run id of each enter token.  On CUDA tensors it runs
``csrc/mono_gather.cu`` (the port of the reference's Pallas
``mono_gather._kernel``), which takes any ``rid``; on CPU tensors its
plain twin (the reference's ``_lax_gather``, JAX's index clamp
included).  ``monotone_gather_batched(values[B, V, R], rid[B, T])`` is
the same expansion of every document in one launch, each ``rid``
clamped against its own document's R.
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


def plain_gather_batched(values: torch.Tensor,
                         rid: torch.Tensor) -> torch.Tensor:
    """Twin over documents: ``out[b] = plain_gather(values[b],
    rid[b])``."""
    i = jax_index(rid, values.shape[2])
    return torch.gather(values, 2, i[:, None, :].expand(
        -1, values.shape[1], -1))


def _checked(values: torch.Tensor, rid: torch.Tensor, docs: bool):
    """The device of a valid call; ``ValueError`` for any other."""
    dev = values.device
    lead = 1 if docs else 0
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if values.dtype != torch.int32 or values.dim() != 2 + lead or \
            not values.is_contiguous() or values.shape[lead] < 1 or \
            values.shape[lead + 1] < 1:
        raise ValueError("values must be a contiguous non-empty int32 "
                         + ("[B, V, R]" if docs else "[V, R]"))
    if rid.dtype != torch.int32 or rid.dim() != 1 + lead or \
            not rid.is_contiguous() or rid.device != dev or \
            (docs and rid.shape[0] != values.shape[0]):
        raise ValueError("rid must be a contiguous int32 "
                         + ("[B, T]" if docs else "[T]")
                         + " on the values' device")
    return dev


def _launch(values: torch.Tensor, rid: torch.Tensor, docs: bool):
    b = values.shape[0] if docs else 1
    v, r = values.shape[-2:]
    t = rid.shape[-1]
    out = torch.empty(values.shape[:-1] + (t,), dtype=torch.int32,
                      device=values.device)
    if t and b:
        lib = build.load()
        tail = (v, r, rid.data_ptr(), t, out.data_ptr(),
                build.stream_ptr(values.device))
        if docs:
            build.check(lib.crdt_monotone_gather_batched(
                values.data_ptr(), b, *tail), "crdt_monotone_gather_batched")
        else:
            build.check(lib.crdt_monotone_gather(values.data_ptr(), *tail),
                        "crdt_monotone_gather")
        kernels.launches["monotone_gather_batched" if docs
                         else "monotone_gather"] += 1
    return out


@chainaudit.kernel_call
def monotone_gather(values: torch.Tensor, rid: torch.Tensor) -> torch.Tensor:
    """``values[:, rid]``: the CUDA kernel on CUDA tensors, the twin on
    CPU tensors; any other device, and arguments the kernel does not
    take, raise ``ValueError`` on either."""
    if _checked(values, rid, False).type == "cpu":
        return plain_gather(values, rid)
    return _launch(values, rid, False)


@chainaudit.kernel_call
def monotone_gather_batched(values: torch.Tensor,
                            rid: torch.Tensor) -> torch.Tensor:
    """``values[b][:, rid[b]]`` for every document b of ``values[B, V,
    R]`` and ``rid[B, T]``: one launch of the CUDA kernel on CUDA
    tensors, the twin on CPU tensors; any other device, and arguments
    the kernel does not take, raise ``ValueError`` on either."""
    if _checked(values, rid, True).type == "cpu":
        return plain_gather_batched(values, rid)
    return _launch(values, rid, True)
