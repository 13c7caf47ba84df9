"""The tour-tail prefix sums (merge stage 6), whole and sharded.

``prefix_sums(boundary, weights)`` returns the inclusive int32 cumsums of
``boundary[T]`` (the run-id stream over the Euler-tour tokens) and of
each row of ``weights[Kw, M]`` (the node-weight lanes), every lane on its
own.  On CUDA tensors it runs the single-pass decoupled look-back scan of
``csrc/prefix_sums.cu`` (the port of the reference's Pallas
``tour_scan._kernel``), over the tiles :func:`scan_plan` counts; on CPU
tensors its plain twin (the reference's ``_lax_prefix``).
``prefix_sums_batched`` scans every document of ``boundary[B, T]`` and
``weights[B, Kw, M]`` in one launch, each lane restarting at its own
first element.

The ops-axis sharded merge (``parallel.opsaxis``) splits the same scans
into k contiguous chunks: each shard scans its own chunk (through
``prefix_sums``), the chunks' totals are exchanged around the ring by
``ring_exclusive`` — the port of the reference's Pallas
``ring_exclusive_pallas``, ``csrc/ring_carry.cu`` on CUDA tensors — and
each shard adds its exclusive carry (``sharded_prefix_sums``).  Integer
addition is associative and wraps the same way in any order, so the
sharded scans equal the whole ones bit for bit.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import List, Sequence, Tuple

import torch

from .. import kernels
from ..kernels import build
from ..utils import chainaudit

SCAN_TILE = 4096   # elements per tile of csrc/prefix_sums.cu (SCAN_TILE)
RING_MAX_SHARDS = 64   # csrc/ring_carry.cu (RING_MAX_SHARDS)
RING_OPS = ("add", "max")


def plain_prefix(boundary: torch.Tensor, weights: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin: ``cumsum(boundary)`` and ``cumsum(weights, 1)``, int32."""
    return (torch.cumsum(boundary, 0, dtype=torch.int32),
            torch.cumsum(weights, 1, dtype=torch.int32))


def plain_prefix_batched(boundary: torch.Tensor, weights: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin over documents: ``plain_prefix(boundary[b], weights[b])`` for
    every document b (int32, wrapping, restarting at each document)."""
    return (torch.cumsum(boundary, 1, dtype=torch.int32),
            torch.cumsum(weights, 2, dtype=torch.int32))


def scan_plan(t: int, kw: int, m: int, b: int = 1) -> Tuple[int, int, int]:
    """The tile plan of kernel 3 for ``b`` documents' ``boundary[t]`` and
    ``weights[kw, m]``: (tiles of each boundary lane, tiles of each
    weight lane, 8-byte scratch words: the tile counter and one status
    word a tile — 0 when there is nothing to scan)."""
    if min(t, kw, m, b) < 0:
        raise ValueError(f"negative extent in ({b}, {t}, {kw}, {m})")
    tiles_b, tiles_w = -(-t // SCAN_TILE), -(-m // SCAN_TILE)
    tiles = b * (tiles_b + kw * tiles_w)
    return tiles_b, tiles_w, 1 + tiles if tiles else 0


def _scan(boundary: torch.Tensor, weights: torch.Tensor, docs: bool):
    """Check the operands, then run the twin (CPU) or one launch (CUDA);
    ``docs``: they carry a leading document axis.

    On the card both results and the kernel's scratch are views of one
    allocation (each result starts on a 16-byte boundary)."""
    dev = boundary.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    lead = 1 if docs else 0
    for x, nd in ((boundary, 1 + lead), (weights, 2 + lead)):
        if x.dtype != torch.int32 or x.dim() != nd or \
                not x.is_contiguous() or x.device != dev:
            raise ValueError(
                "boundary must be int32 [B, T] and weights int32 [B, Kw, "
                "M], contiguous, on one device" if docs else
                "boundary must be int32 [T] and weights int32 [Kw, M], "
                "contiguous, on one device")
    if docs and boundary.shape[0] != weights.shape[0]:
        raise ValueError("boundary and weights must have one document axis")
    if dev.type == "cpu":
        return (plain_prefix_batched if docs else plain_prefix)(
            boundary, weights)
    b = boundary.shape[0] if docs else 1
    t = boundary.shape[-1]
    kw, m = weights.shape[-2:]
    _, _, words = scan_plan(t, kw, m, b)
    # one allocation: [ob | ow | scratch], each part 16-byte aligned
    at_w = -(-(b * t) // 4) * 4
    at_s = at_w + -(-(b * kw * m) // 4) * 4
    buf = torch.empty(at_s + 2 * words, dtype=torch.int32, device=dev)
    ob = buf.as_strided(boundary.shape, boundary.stride())
    ow = buf.as_strided(weights.shape, weights.stride(), at_w)
    if words:
        p = buf.data_ptr()
        lib = build.load()
        scratch = (p + 4 * at_s, words, build.stream_ptr(dev))
        if docs:
            build.check(lib.crdt_prefix_sums_batched(
                boundary.data_ptr(), p, b, t, weights.data_ptr(),
                p + 4 * at_w, kw, m, *scratch), "crdt_prefix_sums_batched")
        else:
            build.check(lib.crdt_prefix_sums(
                boundary.data_ptr(), p, t, weights.data_ptr(), p + 4 * at_w,
                kw, m, *scratch), "crdt_prefix_sums")
        kernels.launches["prefix_sums_batched" if docs
                         else "prefix_sums"] += 1
    return ob, ow


@chainaudit.kernel_call
def prefix_sums(boundary: torch.Tensor, weights: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive prefix sums of i32 ``boundary[T]`` and of each row of
    i32 ``weights[Kw, M]``: the CUDA kernel on CUDA tensors, the twin on
    CPU tensors; any other device, and arguments the kernel does not
    take, raise ``ValueError`` on either."""
    return _scan(boundary, weights, False)


@chainaudit.kernel_call
def prefix_sums_batched(boundary: torch.Tensor, weights: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`prefix_sums` of every document of i32 ``boundary[B, T]``
    and ``weights[B, Kw, M]`` in one launch (each lane restarts at its
    own first element): the CUDA kernel on CUDA tensors, the twin on CPU
    tensors."""
    return _scan(boundary, weights, True)


# ---- the ring carry exchange (kernel 5) ---------------------------------

def plain_ring_exclusive(vals: Sequence[torch.Tensor],
                         op: str = "add") -> List[torch.Tensor]:
    """Twin of kernel 5: shard i's [L] result is the combine of the
    [L] vectors of every shard j < i (shard 0: zeros) — a shifted
    ``cumsum`` (int32, wrapping) or ``cummax`` over the stacked [k, L]
    carries.  ``max`` starts from 0, the reference's ppermute zero-fill,
    so negative carries clamp to 0.  Each result lies on its input's
    device."""
    if op not in RING_OPS:
        raise ValueError(f"unknown ring op {op!r}")
    if not vals:
        return []
    home = vals[0].device
    v = torch.stack([x.to(home, torch.int32) for x in vals])
    if op == "add":
        incl = torch.cumsum(v, 0, dtype=torch.int32)
    else:
        incl = torch.cummax(v, 0).values.clamp(min=0)
    ex = torch.cat([torch.zeros_like(incl[:1]), incl[:-1]])
    return [ex[i].to(vals[i].device) for i in range(len(vals))]


_peers_enabled = set()


def _enable_peers(lib, launch: torch.device, devices) -> None:
    """Open the launching card's context to every other card a buffer
    lies on (once per pair); raises where a pair has no peer path."""
    for d in devices:
        pair = (launch.index, d.index)
        if pair not in _peers_enabled:
            build.check(lib.crdt_enable_peer_access(*pair),
                        f"crdt_enable_peer_access{pair}")
            _peers_enabled.add(pair)


@chainaudit.kernel_call
def ring_exclusive(vals: Sequence[torch.Tensor],
                   op: str = "add") -> List[torch.Tensor]:
    """The exclusive ring exchange of k per-shard int32 [L] carry
    vectors (see :func:`plain_ring_exclusive`): the CUDA kernel when the
    vectors lie on CUDA devices (one launch, on shard 0's card, at most
    64 shards; shards on other cards are reached by peer access), the
    twin when they lie on the CPU.  Returns one [L] tensor per shard, on
    that shard's device (on one card, the rows of one [k, L] tensor)."""
    if op not in RING_OPS:
        raise ValueError(f"unknown ring op {op!r}")
    if not vals:
        return []
    types = {x.device.type for x in vals}
    if types == {"cpu"}:
        return plain_ring_exclusive(vals, op)
    if types != {"cuda"}:
        raise ValueError(f"unsupported devices {sorted(types)}")
    k = len(vals)
    shape = vals[0].shape
    if k > RING_MAX_SHARDS:
        raise ValueError(f"{k} shards exceed the kernel's "
                         f"{RING_MAX_SHARDS}")
    for x in vals:
        if x.dtype != torch.int32 or x.shape != shape or len(shape) != 1 \
                or not x.is_contiguous():
            raise ValueError("carries must be contiguous int32 [L] "
                             "vectors of one length")
    lib = build.load()
    n = shape[0]
    launch = vals[0].device
    others = {x.device for x in vals} - {launch}
    if others:
        out = [torch.empty_like(x) for x in vals]
    else:
        # one card: the k results are the rows of one allocation
        out = list(torch.empty((k, n), dtype=torch.int32, device=launch))
    if n == 0:
        return out
    # host arrays of the k pointers (ctypes passes an array as its address)
    args = ((ctypes.c_void_p * k)(*[x.data_ptr() for x in vals]),
            (ctypes.c_void_p * k)(*[y.data_ptr() for y in out]),
            k, n, RING_OPS.index(op))
    if not others:
        # the current stream's raw handle; the device context only when
        # another card is current
        here = launch.index is None or \
            launch.index == torch.cuda.current_device()
        with contextlib.nullcontext() if here else torch.cuda.device(launch):
            build.check(lib.crdt_ring_exclusive(
                *args, build.stream_ptr(launch)), "crdt_ring_exclusive")
        kernels.launches["ring_exclusive"] += 1
        return out
    stream = torch.cuda.current_stream(launch)
    _enable_peers(lib, launch, others)
    for d in others:
        # the carries were written on their own cards' streams
        stream.wait_stream(torch.cuda.current_stream(d))
    with torch.cuda.device(launch):
        build.check(lib.crdt_ring_exclusive(*args, stream.cuda_stream),
                    "crdt_ring_exclusive")
    kernels.launches["ring_exclusive"] += 1
    for d in others:
        torch.cuda.current_stream(d).wait_stream(stream)
    return out


# ---- the sharded prefix sums ---------------------------------------------

def sharded_prefix_sums(boundary: torch.Tensor, weights: torch.Tensor,
                        part) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`prefix_sums` with every scan split into the k chunks of the
    ops-axis context ``part`` (``parallel.opsaxis.OpsAxisPart``), as the
    reference's ``sharded_prefix_sums`` splits them:

    - the token axis is re-laid as ``[2, k·W]`` (W = ceil(M/k)): the
      enter half (the first M tokens) and the exit half, each zero-padded
      to k·W, so each shard scans one W-wide chunk of each half and of
      each weight lane — one ``prefix_sums`` launch per shard;
    - the ``2 + Kw`` chunk totals ride ONE ring exchange;
    - the exit half's carry also folds the whole enter half (the sum of
      the enter chunks' totals, the reference's ``psum``).

    Operands and results lie on the merge's device; shard i's scans on
    ``part``'s device i."""
    k = part.k
    t = boundary.shape[0]
    kw, m = weights.shape
    w = -(-m // k)
    t_lo = min(m, t)
    if t - t_lo > k * w:
        raise ValueError(f"{t} tokens exceed two halves of {k * w}")
    b32 = boundary.to(torch.int32)
    w32 = weights.to(torch.int32)
    ca, cb, cw, totals = [], [], [], []
    for i in range(k):
        with part._on(i, b32) as dev:
            ent = part._local(b32[:t_lo], w, i, dev)
            ext = part._local(b32[t_lo:], w, i, dev)
            lanes = torch.cat([ext[None, :],
                               part._local(w32.T, w, i, dev).T])
            a, bw = prefix_sums(ent, lanes.contiguous())
            ca.append(a)
            cb.append(bw[0])
            cw.append(bw[1:])
            totals.append(torch.cat([a[-1:], bw[:, -1]]))
    ex = part.ring(totals, "add")
    home = b32.device
    ent_total = part._join([a[-1:] for a in ca], "add", home)
    out_a, out_b, out_w = [], [], []
    for i in range(k):
        with part._on(i, b32) as dev:
            out_a.append(ca[i] + ex[i][0])
            out_b.append(cb[i] + ex[i][1] + ent_total.to(dev))
            out_w.append(cw[i] + ex[i][2:, None])
    flat_a = part._ag(out_a, t_lo, home)
    flat_b = part._ag(out_b, t - t_lo, home)
    ow = part._ag_lanes(out_w, m, home)
    return torch.cat([flat_a, flat_b]), ow.contiguous()
