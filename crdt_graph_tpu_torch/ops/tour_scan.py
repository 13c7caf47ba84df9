"""The tour-tail prefix sums (merge stage 6).

``prefix_sums(boundary, weights)`` returns the inclusive int32 cumsums of
``boundary[T]`` (the run-id stream over the Euler-tour tokens) and of
each row of ``weights[Kw, M]`` (the node-weight lanes), every lane on its
own.  On CUDA tensors it runs the three-phase scan of
``csrc/prefix_sums.cu`` (the port of the reference's Pallas
``tour_scan._kernel``); on CPU tensors its plain twin (the reference's
``_lax_prefix``).

The reference's ring-carry kernel for the ops-axis sharded merge
(``tour_scan.ring_exclusive_pallas``) is multi-device and is not part of
this package yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels

SCAN_TILE = 4096   # elements per block of csrc/prefix_sums.cu (SCAN_TILE)


def plain_prefix(boundary: torch.Tensor, weights: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin: ``cumsum(boundary)`` and ``cumsum(weights, 1)``, int32."""
    return (torch.cumsum(boundary, 0, dtype=torch.int32),
            torch.cumsum(weights, 1, dtype=torch.int32))


def prefix_sums(boundary: torch.Tensor, weights: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive prefix sums of i32 ``boundary[T]`` and of each row of
    i32 ``weights[Kw, M]``: the CUDA kernel on CUDA tensors, the twin on
    CPU tensors (any other device raises)."""
    if boundary.device.type == "cpu":
        return plain_prefix(boundary, weights)
    if boundary.device.type != "cuda":
        raise ValueError(f"unsupported device {boundary.device}")
    from ..kernels import build
    for x, nd in ((boundary, 1), (weights, 2)):
        if x.dtype != torch.int32 or x.dim() != nd or \
                not x.is_contiguous() or x.device != boundary.device:
            raise ValueError("boundary must be int32 [T] and weights int32 "
                             "[Kw, M], contiguous, on one device")
    lib = build.load()
    t = boundary.shape[0]
    kw, m = weights.shape
    ob = torch.empty_like(boundary)
    ow = torch.empty_like(weights)
    nblk = -(-max(t, m) // SCAN_TILE)
    if nblk:
        scratch = torch.empty((1 + kw) * nblk, dtype=torch.int32,
                              device=boundary.device)
        build.check(lib.crdt_prefix_sums(
            boundary.data_ptr(), ob.data_ptr(), t, weights.data_ptr(),
            ow.data_ptr(), kw, m, scratch.data_ptr(), scratch.numel(),
            build.stream_ptr(boundary.device)), "crdt_prefix_sums")
        kernels.launches["prefix_sums"] += 1
    return ob, ow
