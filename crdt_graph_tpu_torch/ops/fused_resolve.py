"""The node-frame row gather, one hop or two (merge stage 2).

``plane_rows(plane, idx)`` is ``plane[idx]`` for an int64 ``plane[R, C]``
and int32 ``idx[T]``; ``plane_rows2(plane, idx, hop_col)`` also follows
each gathered row's ``hop_col`` entry to a second row of the same plane
(zeros where that hop is negative).  The merge gathers every per-node
column through the canonical-source-row index in one sweep of this plane.

Each wrapper runs its CUDA kernel (``csrc/plane_rows.cu``, the port of
the reference's Pallas ``fused_resolve._kernel`` / ``_kernel2``) on CUDA
tensors and its plain PyTorch twin on CPU tensors — the twins are the
statement of what the kernels compute (the reference's ``_lax_rows`` /
``_lax_rows2``, JAX's index clamp included).  :func:`row_plan` states
kernel 1's launch geometry as its C entry point chooses it.

``plane_rows_batched`` / ``plane_rows2_batched`` are the same gathers
over a leading document axis (``plane[B, R, C]``, ``idx[B, T]``): each
document's rows are gathered from its own plane, every index wrapped and
clamped against that plane's R — the reference's vmapped merge.  One
launch serves the batch.

The span constants and :func:`halo_window_ok` serve the ops-axis
sharded merge (``parallel.opsaxis``): its windowed plane gather reads,
per shard, only a halo of ``SPAN2`` rows around the shard's own slots.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from ..kernels import build
from ..utils import chainaudit
from .indexing import jax_index, take

TILE = 1024           # the reference kernel's output rows per tile
SPAN = TILE + 128     # plane rows its one-hop tile window holds
HOP_J = 1152          # its second-hop locality bound
SPAN2 = SPAN + 2 * HOP_J   # its two-hop window rows per tile

# kernel 1's launch constants (csrc/plane_rows.cu, PLANE_ROWS_*)
ROWS_THREADS = 256       # threads a block (PLANE_ROWS_THREADS)
ROWS_PER_THREAD = 4      # rows in flight a thread (PLANE_ROWS_PER_THREAD)
ROWS_VEC_BYTES = 16      # the wide access: two columns (PLANE_ROWS_VEC_BYTES)


def halo_window_ok(idx: torch.Tensor, w: int, halo: int,
                   nrows: int) -> torch.Tensor:
    """True (a 0-d bool tensor) when every index of ``idx`` lies in its
    shard's halo window: output row j belongs to shard ``j // w``, whose
    window is ``[lo - halo, lo + w + halo)`` with ``lo = (j // w) * w``.
    Indices ``<= 0`` and ``>= nrows - 1`` (the ROOT and NULL rows, which
    the windowed gather overlays elementwise) are exempt.  The caller
    reads it on the host: one synchronising read per windowed sweep, in
    place of the reference's ``lax.cond``."""
    own_lo = torch.div(torch.arange(idx.shape[0], dtype=torch.int32,
                                    device=idx.device), w,
                       rounding_mode="floor") * w
    exempt = (idx <= 0) | (idx >= nrows - 1)
    in_win = (idx >= own_lo - halo) & (idx < own_lo + w + halo)
    return torch.all(exempt | in_win)


def plain_rows(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Twin of kernel 1: ``plane[idx]`` with JAX's wrap-then-clamp."""
    return take(plane, idx)


def plain_rows2(plane: torch.Tensor, idx: torch.Tensor,
                hop_col: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin of kernel 2: ``g = plane[idx]``; ``g2 = plane[clip(hop, 0,
    R-1)]`` with ``hop = g[:, hop_col]``, zeroed where ``hop < 0``."""
    g = take(plane, idx)
    hop = g[:, hop_col]
    g2 = plane[hop.clamp(0, plane.shape[0] - 1)]
    return g, torch.where((hop >= 0)[:, None], g2, 0)


def plain_rows_batched(plane: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """Twin of kernel 1 over documents: ``out[b] = plain_rows(plane[b],
    idx[b])``."""
    c = plane.shape[2]
    i = jax_index(idx, plane.shape[1])
    return torch.gather(plane, 1, i[:, :, None].expand(-1, -1, c))


def plain_rows2_batched(plane: torch.Tensor, idx: torch.Tensor,
                        hop_col: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin of kernel 2 over documents: ``(out[b], out2[b]) =
    plain_rows2(plane[b], idx[b], hop_col)``."""
    g = plain_rows_batched(plane, idx)
    hop = g[:, :, hop_col]
    g2 = plain_rows_batched(plane, hop.clamp(0, plane.shape[1] - 1)
                            .to(torch.int32))
    return g, torch.where((hop >= 0)[:, :, None], g2, 0)


def row_plan(c: int, aligned16: bool) -> Tuple[int, int, int, int]:
    """Kernel 1's launch geometry for a ``C``-column plane, as
    ``crdt_plane_rows`` chooses it: (bytes an access, threads a row,
    rows a block, rows a thread).  An access moves two columns when
    ``C`` is even and ``aligned16`` (plane and output both start on
    16-byte boundaries), else one; a row's thread ``x`` moves its chunks
    ``x, x + threads, ...``."""
    if c < 1:
        raise ValueError(f"a plane has at least one column, not {c}")
    vec = ROWS_VEC_BYTES if c % 2 == 0 and aligned16 else 8
    threads = min(c // (vec // 8), ROWS_THREADS)
    return vec, threads, ROWS_THREADS // threads, ROWS_PER_THREAD


def _check(plane: torch.Tensor, idx: torch.Tensor, docs: bool) -> None:
    lead = 1 if docs else 0
    shape = "[B, R, C]" if docs else "[R, C]"
    if plane.dtype != torch.int64 or plane.dim() != 2 + lead or \
            not plane.is_contiguous() or plane.shape[lead] < 1:
        raise ValueError(f"plane must be a contiguous non-empty int64 "
                         f"{shape}")
    if idx.dtype != torch.int32 or idx.dim() != 1 + lead or \
            not idx.is_contiguous() or \
            (docs and idx.shape[0] != plane.shape[0]):
        raise ValueError("idx must be a contiguous int32 "
                         + ("[B, T]" if docs else "[T]"))
    if idx.device != plane.device:
        raise ValueError("plane and idx must share a device")


def _launch(plane, idx, hop_col, docs: bool = False):
    """One launch of kernel 1 (``hop_col`` None) or 2; ``docs``: the
    operands carry a leading document axis."""
    _check(plane, idx, docs)
    lib = build.load()
    b = plane.shape[0] if docs else 1
    r, c = plane.shape[-2:]
    t = idx.shape[-1]
    out = torch.empty(idx.shape + (c,), dtype=torch.int64,
                      device=plane.device)
    out2 = None if hop_col is None else torch.empty_like(out)
    if t and b:
        tail = (idx.data_ptr(), t, out.data_ptr(),
                None if out2 is None else out2.data_ptr(),
                0 if hop_col is None else int(hop_col),
                build.stream_ptr(plane.device))
        if docs:
            build.check(lib.crdt_plane_rows_batched(
                plane.data_ptr(), b, r, c, *tail), "crdt_plane_rows_batched")
        else:
            build.check(lib.crdt_plane_rows(plane.data_ptr(), r, c, *tail),
                        "crdt_plane_rows")
        name = "plane_rows" if out2 is None else "plane_rows2"
        kernels.launches[name + "_batched" if docs else name] += 1
    return out, out2


@chainaudit.kernel_call
def plane_rows(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``plane[idx]``: the CUDA kernel on CUDA tensors, the twin on CPU
    tensors (any other device raises)."""
    if plane.device.type == "cpu":
        return plain_rows(plane, idx)
    if plane.device.type != "cuda":
        raise ValueError(f"unsupported device {plane.device}")
    return _launch(plane, idx, None)[0]


@chainaudit.kernel_call
def plane_rows2(plane: torch.Tensor, idx: torch.Tensor,
                hop_col: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two-hop sweep (see :func:`plain_rows2`): the CUDA kernel on
    CUDA tensors, the twin on CPU tensors."""
    if plane.device.type == "cpu":
        return plain_rows2(plane, idx, hop_col)
    if plane.device.type != "cuda":
        raise ValueError(f"unsupported device {plane.device}")
    if not 0 <= hop_col < plane.shape[1]:
        raise ValueError(f"hop_col {hop_col} outside the plane")
    return _launch(plane, idx, hop_col)


@chainaudit.kernel_call
def plane_rows_batched(plane: torch.Tensor, idx: torch.Tensor
                       ) -> torch.Tensor:
    """``plane[b][idx[b]]`` for every document b of ``plane[B, R, C]``
    and ``idx[B, T]``: one launch of the CUDA kernel on CUDA tensors,
    the twin on CPU tensors (any other device raises)."""
    if plane.device.type == "cpu":
        return plain_rows_batched(plane, idx)
    if plane.device.type != "cuda":
        raise ValueError(f"unsupported device {plane.device}")
    return _launch(plane, idx, None, docs=True)[0]


@chainaudit.kernel_call
def plane_rows2_batched(plane: torch.Tensor, idx: torch.Tensor,
                        hop_col: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two-hop sweep of every document (see
    :func:`plain_rows2_batched`): one launch of the CUDA kernel on CUDA
    tensors, the twin on CPU tensors."""
    if plane.device.type == "cpu":
        return plain_rows2_batched(plane, idx, hop_col)
    if plane.device.type != "cuda":
        raise ValueError(f"unsupported device {plane.device}")
    if not 0 <= hop_col < plane.shape[-1]:
        raise ValueError(f"hop_col {hop_col} outside the plane")
    return _launch(plane, idx, hop_col, docs=True)
