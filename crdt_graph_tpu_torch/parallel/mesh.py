"""Docs-axis batching: B independent merges whose tables carry a leading
document axis.

A server merging many documents batches them on a leading axis: merges
never communicate across documents, so each document's slice of the
batched table is exactly its own single merge.  The serving scheduler
(serve/scheduler.py) groups two or more same-bucket kernel merges of one
round through :func:`stack_aligned` → :func:`materialize_each`.

The reference runs the B merges as one ``vmap``-ed launch sharded over a
``docs`` mesh axis, with its Pallas kernels switched off (they cannot
trace under ``vmap``).  Here the kernels stay on: the B merges run back
to back on the caller's current stream, each taking its own host
decisions (leg, no-deletes promise, predicate reads), each table at the
shared capacity; :func:`batched_materialize` stacks them into
``[B, ...]`` as the reference's batched table.  A launch with a
document axis in the kernels' grids is later work (ROADMAP).  The
reference's ``make_mesh`` / ``sharded_materialize`` (the XLA-partitioned
ops axis) have no counterpart here; the explicit ops-axis merge is
``parallel.opsaxis``.

Entry points:

- :func:`stack_packed` / :func:`stack_aligned` — per-document packed
  ops → ``[B, N]`` numpy columns (aligned: every batch re-padded to the
  shared capacity first).
- :func:`materialize_each` — the ``[B, N]`` columns → one
  :class:`~crdt_graph_tpu_torch.ops.merge.NodeTable` per document on
  ``device`` (the card unless the caller names another).
- :func:`batched_materialize` — the same tables stacked into one
  ``NodeTable`` of ``[B, ...]`` tensors.
- :func:`doc_table` — document ``i``'s slice of a batched table.
- :class:`LingerBatcher` — the cross-caller accumulation window (the
  merge worker's epochs, mergetier/worker.py).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..codec.packed import PackedOps, with_capacity
from ..codec.packed import pad_arrays as packed_pad_arrays
from ..ops import merge as merge_mod
from ..ops.merge import FIELDS, NodeTable

# the position hints the default (join) body drops, as the reference's
# batched body does: its hinted path's ``lax.cond`` would run both
# branches under ``vmap``, so it joins instead
POS_HINTS = ("parent_pos", "anchor_pos", "target_pos")


def materialize_each(ops: Dict[str, np.ndarray], device=None,
                     exhaustive_hints: bool = False) -> List[NodeTable]:
    """B independent merges: arrays carry a leading document axis
    ``[B, N]`` (:func:`stack_packed`).  Returns one
    :class:`NodeTable` per document, each at the shared capacity ``N``,
    on ``device`` — the form the serving scheduler commits from.

    The default drops the position hints and runs ``hints="join"``,
    which is correct for any input.  ``exhaustive_hints=True`` runs
    ``hints="exhaustive"`` — ONLY for batches whose link-hint coverage
    the caller vouches for (pack/stack_packed provenance); a violated
    promise silently mis-resolves references."""
    dev = merge_mod.resolve_device(device)
    b = int(ops["kind"].shape[0])
    if b < 1:
        raise ValueError("batched_materialize needs at least one document")
    hints = "exhaustive" if exhaustive_hints else "join"
    keys = [k for k in ops if exhaustive_hints or k not in POS_HINTS]
    tables = []
    for i in range(b):
        one = {k: ops[k][i] for k in keys}
        tables.append(merge_mod._materialize(
            one, hints, dev, merge_mod.host_no_deletes(one["kind"])))
    return tables


def batched_materialize(ops: Dict[str, np.ndarray], device=None,
                        exhaustive_hints: bool = False) -> NodeTable:
    """:func:`materialize_each` with the tables stacked into one
    :class:`NodeTable` whose every field has the leading document axis
    — the reference's batched table, field for field."""
    tables = materialize_each(ops, device, exhaustive_hints)
    return NodeTable(**{f: torch.stack([getattr(t, f) for t in tables])
                        for f in FIELDS})


def doc_table(btab: NodeTable, i: int) -> NodeTable:
    """Document ``i``'s slice of a :func:`batched_materialize` table
    (views, no copy)."""
    return NodeTable(**{f: getattr(btab, f)[i] for f in FIELDS})


def stack_aligned(batches: Sequence[PackedOps]
                  ) -> "tuple[Dict[str, np.ndarray], list]":
    """:func:`stack_packed` plus per-document capacity alignment: every
    batch is first re-padded to the SHARED capacity (codec.packed
    ``with_capacity``) and the aligned PackedOps are returned alongside
    the stacked arrays.  The serving scheduler commits each document
    against its slice of the batched table, so the per-document columns
    it parks must have the same row capacity the table was materialized
    at — stacking alone would leave them inconsistent."""
    shared = max(p.capacity for p in batches)
    aligned = [with_capacity(p, shared) for p in batches]
    return stack_packed(aligned), aligned


class LingerBatcher:
    """Cross-caller batch accumulation window for the batched merge.

    Many threads each hold ONE item (a document's prepared candidate
    set) and want it materialized; a wide batched merge
    amortizes launch overhead across all of them, but only if their
    arrivals meet in the same launch.  :meth:`submit` parks the caller
    while a shared window fills: the FIRST arrival becomes the epoch's
    leader and waits up to ``linger_s`` for co-travellers, launching
    early the moment ``max_width`` items are aboard; everyone else
    rides, and every submitter gets exactly its own item's result back.
    A failed launch fails the WHOLE epoch's submitters (each caller
    falls back on its own).

    ``launch`` receives the epoch's item list and must return one
    result per item, in order.  It runs on the leader's thread; the
    batcher itself never touches the card, so which thread launches is
    the launch callable's business, not ours.
    """

    def __init__(self, launch: Callable[[List[Any]], List[Any]],
                 linger_s: float = 0.002, max_width: int = 16):
        self._launch = launch
        self.linger_s = max(0.0, float(linger_s))
        self.max_width = max(1, int(max_width))
        self._cv = threading.Condition()
        self._epoch = 0
        self._items: List[Any] = []          # current epoch's cargo
        self._done: Dict[int, tuple] = {}    # epoch -> (results, error)
        self._riders: Dict[int, int] = {}    # epoch -> riders not yet woken
        self._closed = False
        # telemetry (read under the cv by stats())
        self.launches = 0
        self.items_in = 0
        self.full_launches = 0               # width cap hit (no linger)
        self.linger_waits = 0                # epochs that waited the window

    def submit(self, item: Any) -> Any:
        """Park until this item's epoch launches; returns its result.
        Raises whatever the epoch's launch raised (every rider sees the
        same error) or ``RuntimeError`` after :meth:`close`."""
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher closed")
            epoch = self._epoch
            self._items.append(item)
            self.items_in += 1
            index = len(self._items) - 1
            leader = index == 0
            if not leader and len(self._items) >= self.max_width:
                # cap reached: wake the lingering leader early
                self._cv.notify_all()
            if leader:
                deadline = time.monotonic() + self.linger_s
                waited = False
                while (len(self._items) < self.max_width
                       and not self._closed):
                    remain = deadline - time.monotonic()
                    if remain <= 0:
                        break
                    waited = True
                    self._cv.wait(remain)
                cargo, self._items = self._items, []
                self._epoch += 1
                if waited:
                    self.linger_waits += 1
                if len(cargo) >= self.max_width:
                    self.full_launches += 1
            else:
                while epoch not in self._done and not self._closed:
                    self._cv.wait(1.0)
                if epoch not in self._done:
                    raise RuntimeError("batcher closed mid-epoch")
                results, error = self._done[epoch]
                # last rider out sweeps the epoch's parking spot
                self._rider_done(epoch)
                if error is not None:
                    raise error
                return results[index]
        # leader, outside the lock: run the launch for the whole epoch
        results: Optional[List[Any]] = None
        error: Optional[BaseException] = None
        try:
            results = self._launch(cargo)
            if results is None or len(results) != len(cargo):
                raise RuntimeError(
                    f"launch returned {0 if results is None else len(results)}"
                    f" results for {len(cargo)} items")
        except BaseException as e:   # noqa: BLE001 — every rider must
            # wake with THIS error, whatever class it is
            error = e
        with self._cv:
            self.launches += 1
            self._done[epoch] = (results, error)
            self._riders[epoch] = len(cargo) - 1
            if self._riders[epoch] == 0:
                del self._done[epoch], self._riders[epoch]
            self._cv.notify_all()
        if error is not None:
            raise error
        return results[0]

    def _rider_done(self, epoch: int) -> None:
        # requires self._cv
        self._riders[epoch] -= 1
        if self._riders[epoch] == 0:
            del self._done[epoch], self._riders[epoch]

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            return {"launches": self.launches,
                    "items_in": self.items_in,
                    "full_launches": self.full_launches,
                    "linger_waits": self.linger_waits,
                    "linger_ms": round(self.linger_s * 1e3, 3),
                    "max_width": self.max_width,
                    "pending": len(self._items)}


def stack_packed(batches: Sequence[PackedOps]) -> Dict[str, np.ndarray]:
    """Stack per-document packed ops into ``[B, N]`` arrays (N = max,
    pad-extended; path planes widened to the widest depth bucket) for
    :func:`batched_materialize`."""
    n = max(p.capacity for p in batches)
    width = max(p.max_depth for p in batches)
    per = []
    for p in batches:
        arrs = dict(p.arrays())
        if arrs["paths"].shape[1] < width:
            wide = np.zeros((arrs["paths"].shape[0], width),
                            dtype=arrs["paths"].dtype)
            wide[:, :arrs["paths"].shape[1]] = arrs["paths"]
            arrs["paths"] = wide
        per.append(packed_pad_arrays(arrs, n))
    # derived slot-hint columns ride along only when EVERY document has
    # them (arrays() omits them for unvouched batches; a mixed stack
    # takes the gather-based resolution rather than trusting half)
    keys = set(per[0])
    for d in per[1:]:
        keys &= set(d)
    return {k: np.stack([d[k] for d in per]) for k in keys}
