"""Ops-axis sharded merge: one document's merge split into k shards.

The port of ``crdt_graph_tpu.parallel.opsaxis``.  The reference runs the
whole merge inside one ``shard_map`` over a 1-D ``ops`` mesh: every
device recomputes the replicated stages, and a partition context
(:class:`OpsAxisPart`) intercepts the merge's memory-bound ops so each
device computes only its own ``ceil(n/k)`` chunk of them, joined by
``all_gather``, ``pmin``/``pmax``/``psum`` or the ring exchange of scan
carries.  The result is the single-device ``NodeTable`` bit for bit.

In one PyTorch process "replicated" means a tensor lives once, on the
merge's device.  :class:`OpsAxisPart` therefore takes whole tensors and
returns whole tensors, as the reference's methods do; inside a method
shard i computes its chunk on ``devices[i]`` and the join happens on the
merge's device:

- ``all_gather`` is a ``cat`` of the chunks in shard order;
- ``pmin``/``pmax``/``psum`` are an elementwise min, max or sum of the k
  frames;
- the carry exchange is kernel 5 (``ops.tour_scan.ring_exclusive``,
  ``csrc/ring_carry.cu``).

On one card ``devices`` is ``[cuda:0] * k``: k logical shards.  On a host
with several cards the same code puts the shards on distinct cards, and
kernel 5 reaches them by peer access.  The stages the reference leaves
replicated run once, on the merge's device, through the port's own code.
Where the port has a kernel for a chunk's work, the shard runs it: the
windowed plane gather runs kernel 1 on its window, the chunk scans
kernel 3, the rank expansion kernel 4 on the shard's ``rid`` chunk.

Where the reference's windowed gather falls back with ``lax.cond``, the
port reads the window predicate on the host (one counted synchronising
read per windowed sweep, ``merge.host_syncs``) and takes the
single-device gather; each fallback counts in :data:`halo_fallbacks`.

The route: ``engine.TpuTree``'s bulk merges go through
:func:`routed_materialize`, which takes this path only where
:func:`enabled_for` says so — ``GRAFT_OPSAXIS=1``, at least two cards,
at least ``GRAFT_OPSAXIS_MIN_OPS`` rows (default 2^18) and a capacity
the mesh width divides.  Unlike the reference, whose route is on by
default, the port's is off unless asked for: one process drives every
shard, so the shards' launches run one after another on the host, and
no card count has yet been measured where that beats the single-device
merge.  On one card the route is off either way, as in the reference, so
only an explicit ``k`` runs the sharded merge there.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..codec import packed as packed_mod
from ..ops import fused_resolve, merge as merge_mod, mono_gather, tour_scan
from ..ops.indexing import add_drop, max_drop, min_drop, set_drop, take
from ..ops.merge import NodeTable
from ..utils import chainaudit, hostenv
from . import collectives

AXIS = "ops"

# Static halo rows per shard edge for the windowed plane sweeps: the
# reference's two-hop span bound (fused_resolve.SPAN2 = SPAN + 2·HOP_J).
# A vouched near-diagonal batch's source rows stay within it; a batch
# whose rows stray takes the single-device gather.
HALO = fused_resolve.SPAN2

# Windowed plane sweeps that fell back to the single-device gather since
# the last reset.
halo_fallbacks = 0


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class OpsAxisPart:
    """The partition context threaded through ``merge._resolve`` and
    ``merge._finish``: the sharded forms of the merge's memory-bound
    ops.  Every method takes whole tensors on the merge's device and
    returns whole tensors there; shard i works on ``devices[i]`` (the
    operand's own device when ``devices`` is None)."""

    def __init__(self, k: int, devices: Optional[Sequence] = None):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if devices is not None and len(devices) != k:
            raise ValueError(f"{len(devices)} devices for {k} shards")
        self.k = k
        self.devices = None if devices is None else \
            [torch.device(d) for d in devices]
        self.halo = HALO

    # -- chunk helpers -------------------------------------------------------

    def _w(self, n: int) -> int:
        return _ceil_div(n, self.k)

    @contextlib.contextmanager
    def _on(self, i: int, like: torch.Tensor):
        """Shard i's device (made current when it is a card); the
        trace audit marks what runs inside as the shard's."""
        dev = like.device if self.devices is None else self.devices[i]
        with chainaudit.shard(), (torch.cuda.device(dev) if dev.type ==
                                  "cuda" else contextlib.nullcontext()):
            yield dev

    def _local(self, arr: torch.Tensor, w: int, i: int,
               dev: torch.device, fill=0) -> torch.Tensor:
        """Shard i's contiguous chunk (rows ``i*w`` .. ``i*w + w``) of a
        whole tensor, padded with ``fill`` to ``w`` rows, on ``dev``."""
        chunk = arr[i * w:(i + 1) * w]
        short = w - chunk.shape[0]
        if short:
            chunk = torch.cat([chunk, torch.full(
                (short,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                device=arr.device)])
        return chunk.to(dev).contiguous()

    @staticmethod
    def _ag(chunks: List[torch.Tensor], n: int,
            home: torch.device) -> torch.Tensor:
        """The chunks in shard order, on ``home``, cut to ``n`` rows (the
        reference's tiled ``all_gather``)."""
        out = torch.cat([c.to(home) for c in chunks])[:n]
        collectives.note("all-gather", out)
        return out

    @staticmethod
    def _ag_lanes(chunks: List[torch.Tensor], n: int,
                  home: torch.device) -> torch.Tensor:
        """:meth:`_ag` along the last axis: ``[V, w]`` chunks → ``[V, n]``."""
        out = torch.cat([c.to(home) for c in chunks], dim=1)[:, :n]
        collectives.note("all-gather", out)
        return out

    @staticmethod
    def _join(frames: List[torch.Tensor], how: str,
              home: torch.device) -> torch.Tensor:
        """The elementwise min, max or sum of the shards' frames on
        ``home`` (the reference's ``pmin``/``pmax``/``psum``)."""
        acc = frames[0].to(home)
        for f in frames[1:]:
            f = f.to(home)
            acc = torch.minimum(acc, f) if how == "min" else \
                torch.maximum(acc, f) if how == "max" else acc + f
        collectives.note("all-reduce", acc)
        return acc

    @staticmethod
    def ring(carries: List[torch.Tensor], op: str) -> List[torch.Tensor]:
        """The exclusive ring exchange of the shards' carries (kernel 5,
        ``tour_scan.ring_exclusive``; the reference's ``ppermute``
        ring)."""
        out = tour_scan.ring_exclusive(carries, op)
        collectives.note("collective-permute", out)
        return out

    # -- halo-windowed plane row gather --------------------------------------

    def plane_rows(self, plane: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
        """``plane[idx]`` for an int64 ``plane[R, C]``, each shard
        gathering its own ``ceil(len/k)`` output rows with kernel 1 from
        a ``[W + 2·HALO]``-row window around its slot range, at local
        offsets.  ROOT (row 0) and NULL (row R-1) reads are overlaid
        elementwise.  When some other index strays outside its shard's
        window (one host read of :func:`fused_resolve.halo_window_ok`)
        the whole gather is the single-device kernel-1 gather."""
        global halo_fallbacks
        r, c = plane.shape
        mi = idx.shape[0]
        w = self._w(mi)
        wwin = w + 2 * self.halo
        if not merge_mod._read(fused_resolve.halo_window_ok(
                idx, w, self.halo, r)):
            halo_fallbacks += 1
            return fused_resolve.plane_rows(plane.contiguous(),
                                            idx.to(torch.int32).contiguous())
        plane_p = plane
        if r < wwin:
            plane_p = torch.cat([plane, torch.zeros(
                (wwin - r, c), dtype=plane.dtype, device=plane.device)])
        rp = plane_p.shape[0]
        out = []
        for i in range(self.k):
            start = min(max(i * w - self.halo, 0), rp - wwin)
            with self._on(i, plane) as dev:
                win = plane_p[start:start + wwin].to(dev).contiguous()
                idx_l = self._local(idx.to(torch.int32), w, i, dev)
                off = torch.clamp(idx_l - start, 0, wwin - 1)
                g = fused_resolve.plane_rows(win, off.contiguous())
                g = torch.where((idx_l <= 0)[:, None],
                                plane[0].to(dev)[None, :], g)
                g = torch.where((idx_l >= r - 1)[:, None],
                                plane[r - 1].to(dev)[None, :], g)
            out.append(g)
        return self._ag(out, mi, plane.device)

    # -- per-row gathers from whole frames -----------------------------------

    def gather_rows(self, table: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
        """``table[idx]`` (JAX's clamp) with the INDEX axis sharded: each
        shard gathers its own ``ceil(len/k)`` rows — by kernel 1 when
        ``table`` is an int64 plane — and the chunks join in order."""
        n = idx.shape[0]
        w = self._w(n)
        plane = table.dtype == torch.int64 and table.dim() == 2
        out = []
        for i in range(self.k):
            with self._on(i, table) as dev:
                tab = table.to(dev)
                idx_l = self._local(idx, w, i, dev)
                out.append(fused_resolve.plane_rows(
                    tab.contiguous(), idx_l.to(torch.int32).contiguous())
                    if plane else take(tab, idx_l))
        return self._ag(out, n, table.device)

    # -- frame scatters joined elementwise -----------------------------------

    def _pad_pairs(self, size: int, tgt, val, w: int, i: int, dev):
        """Shard i's (target, value) chunk; pad rows target ``size``,
        which every frame write drops."""
        return (self._local(tgt, w, i, dev, fill=size),
                self._local(val, w, i, dev))

    def frame_set(self, size: int, default, tgt: torch.Tensor,
                  val: torch.Tensor, combine: str,
                  dtype=torch.int32) -> torch.Tensor:
        """``full(size, default).at[tgt].set(val, mode="drop")`` with the
        index axis sharded and the shards' frames joined by min or max —
        exact when targets are unique and every written value beats
        ``default`` under the combine."""
        n = tgt.shape[0]
        w = self._w(n)
        frames = []
        for i in range(self.k):
            with self._on(i, tgt) as dev:
                t_l, v_l = self._pad_pairs(size, tgt, val, w, i, dev)
                frames.append(set_drop(torch.full(
                    (size,), default, dtype=dtype, device=dev), t_l,
                    v_l.to(dtype)))
        return self._join(frames, combine, tgt.device)

    def frame_reduce(self, size: int, default, tgt: torch.Tensor,
                     val: torch.Tensor, op: str) -> torch.Tensor:
        """``full(size, default).at[tgt].min/max(val, mode="drop")`` with
        repeated targets allowed: per-shard reduce frames joined by min
        or max (associative, and ``default`` is their identity)."""
        n = tgt.shape[0]
        w = self._w(n)
        red = min_drop if op == "min" else max_drop
        frames = []
        for i in range(self.k):
            with self._on(i, tgt) as dev:
                t_l, v_l = self._pad_pairs(size, tgt, val, w, i, dev)
                frames.append(red(torch.full((size,), default,
                                             dtype=val.dtype, device=dev),
                                  t_l, v_l))
        return self._join(frames, op, tgt.device)

    def frame_add(self, size: int, tgt: torch.Tensor) -> torch.Tensor:
        """``zeros(size).at[tgt].add(1, mode="drop")``: per-shard counts
        joined by a sum (int32).  Targets at or past ``size`` and the pad
        rows past the last target drop."""
        n = tgt.shape[0]
        w = self._w(n)
        capped = torch.where(tgt >= size, size, tgt)
        frames = []
        for i in range(self.k):
            with self._on(i, tgt) as dev:
                t_l = self._local(capped, w, i, dev)
                rows = i * w + torch.arange(w, dtype=torch.int32, device=dev)
                frames.append(add_drop(size, torch.where(rows < n, t_l,
                                                         size)))
        return self._join(frames, "add", tgt.device)

    # -- chunked scans with ring carries -------------------------------------

    def prefix_sums(self, boundary: torch.Tensor, weights: torch.Tensor):
        """The tour-scan prefix sums: chunk scans, one ring exchange of
        the carries, local fixup (``ops.tour_scan.sharded_prefix_sums``)."""
        return tour_scan.sharded_prefix_sums(boundary, weights, self)

    def cumsum(self, x: torch.Tensor) -> torch.Tensor:
        """1-D inclusive int32 cumsum: chunk scans (kernel 3) and a ring
        exchange of the chunk totals."""
        n = x.shape[0]
        w = self._w(n)
        x32 = x.to(torch.int32)
        loc = []
        for i in range(self.k):
            with self._on(i, x) as dev:
                chunk = self._local(x32, w, i, dev)
                loc.append(tour_scan.prefix_sums(chunk, torch.zeros(
                    (0, w), dtype=torch.int32, device=dev))[0])
        carry = self.ring([c[-1:] for c in loc], "add")
        out = []
        for i in range(self.k):
            with self._on(i, x):
                out.append(loc[i] + carry[i][0])
        return self._ag(out, n, x.device)

    def cummax(self, x: torch.Tensor) -> torch.Tensor:
        """1-D inclusive int32 cummax: chunk scans and a ring exchange of
        MAX carries.  Values are biased to >= 1 so the exchange's zero
        start is the identity, and pad rows are re-masked to 0 so they
        cannot raise the last chunk's carry."""
        n = x.shape[0]
        w = self._w(n)
        bias = torch.clamp(1 - torch.min(x), min=0).to(x.dtype)
        loc = []
        for i in range(self.k):
            with self._on(i, x) as dev:
                chunk = self._local(x, w, i, dev) + bias.to(dev)
                rows = i * w + torch.arange(w, dtype=torch.int32, device=dev)
                loc.append(torch.where(rows < n,
                                       torch.cummax(chunk, 0).values, 0))
        carry = self.ring([c[-1:].to(torch.int32) for c in loc], "max")
        out = []
        for i in range(self.k):
            with self._on(i, x) as dev:
                out.append(torch.maximum(loc[i], carry[i][0].to(x.dtype))
                           - bias.to(dev))
        return self._ag(out, n, x.device)

    def mono_expand(self, per_run: torch.Tensor,
                    rid_m: torch.Tensor) -> torch.Tensor:
        """``per_run[:, rid_m]`` (the rank expansion) with the token axis
        sharded: kernel 4 on each shard's ``rid`` chunk, which is still
        nondecreasing with steps <= 1."""
        n = rid_m.shape[0]
        w = self._w(n)
        out = []
        for i in range(self.k):
            with self._on(i, per_run) as dev:
                vals = per_run.to(dev).contiguous()
                rid_l = self._local(rid_m, w, i, dev)
                out.append(mono_gather.monotone_gather(vals, rid_l))
        return self._ag_lanes(out, n, per_run.device)


# ---- the entry point ------------------------------------------------------

_STATS = {"merges": 0, "devices": 0, "routed_ops": 0}
_STATS_LOCK = threading.Lock()
# the shard audit a reporter asked for (:func:`arm_audit`): whether the
# next sharded merge runs under it, and the record of the last one
_AUDIT = {"armed": False, "last": None}


def mesh_devices() -> int:
    """The ops-axis width this host would shard at: the largest power of
    two <= the number of cards (1 with no card)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return 1 << (n.bit_length() - 1) if n else 1


def _host(col) -> np.ndarray:
    return col.cpu().numpy() if isinstance(col, torch.Tensor) else \
        np.asarray(col)


def materialize(ops: Dict, k: Optional[int] = None, hints="auto",
                device=None, devices: Optional[Sequence] = None
                ) -> NodeTable:
    """One ops-axis sharded merge on ``device`` (default: the card),
    equal field for field to ``merge.materialize`` on the same padded
    columns.  With ``k`` None the width is :func:`mesh_devices` and the
    shards lie on the mesh's cards (on ``device`` itself when that is not
    a card); with an explicit ``k`` they are k logical shards on
    ``device``, or on ``devices`` (k of them, e.g. a mesh row) when
    given.  An op count that ``k`` does not divide pads to the next
    multiple (the padded rows ride the last shard), which widens the
    table exactly as padding before ``merge.materialize`` would."""
    run = _Sharded(ops, k, hints, device, devices)
    with _STATS_LOCK:
        _STATS["merges"] += 1
        _STATS["devices"] = run.k
        _STATS["routed_ops"] += int(run.n)
        # an armed audit samples this merge, unless an audit already
        # runs on this thread (a sampled commit's): it waits for the next
        sample = _AUDIT["armed"] and not chainaudit.running()
        if sample:
            _AUDIT["armed"] = False
    if not sample:
        return run.merge()
    table, rec = _audit(run)
    with _STATS_LOCK:
        _AUDIT["last"] = rec
    return table


class _Sharded:
    """One sharded merge's arguments, resolved: the padded host columns,
    the width and the shards' devices."""

    def __init__(self, ops: Dict, k: Optional[int], hints, device,
                 devices: Optional[Sequence] = None):
        if hints not in merge_mod.HINT_MODES:
            raise ValueError(f"unknown hints mode {hints!r}; expected "
                             "None, 'auto', 'exhaustive', or 'join'")
        self.hints = hints
        self.dev = merge_mod.resolve_device(device)
        if devices is not None:
            self.devices = [torch.device(d) for d in devices]
            k = len(self.devices) if k is None else k
        elif k is None and self.dev.type == "cuda":
            k = mesh_devices()
            self.devices = [torch.device("cuda", i) for i in range(k)]
        else:
            k = mesh_devices() if k is None else k
            self.devices = [self.dev] * k
        self.k = k
        cols = {c: _host(v) for c, v in ops.items()}
        self.n = cols["kind"].shape[0]
        n_pad = _ceil_div(self.n, k) * k
        self.cols = packed_mod.pad_arrays(cols, n_pad) \
            if n_pad != self.n else cols
        self.no_deletes = merge_mod.host_no_deletes(self.cols["kind"])

    def merge(self) -> NodeTable:
        return merge_mod._materialize(self.cols, self.hints, self.dev,
                                      self.no_deletes,
                                      part=OpsAxisPart(self.k, self.devices))


# ---- the serving route (engine.py) ----------------------------------------

MIN_OPS_DEFAULT = 1 << 18


def route_min_ops() -> int:
    return hostenv.env_int("GRAFT_OPSAXIS_MIN_OPS", MIN_OPS_DEFAULT)


def route_on() -> bool:
    """The ``GRAFT_OPSAXIS`` switch; off unless set (module docstring)."""
    return hostenv.flag_on("GRAFT_OPSAXIS", default="0")


def enabled_for(n_ops: int) -> bool:
    """True when a candidate set of ``n_ops`` rows takes the sharded
    path: :func:`route_on`, at least two cards, the batch at or past
    :func:`route_min_ops`, and a row count the mesh width divides (so
    the table's shapes are the single-device ones)."""
    if not route_on():
        return False
    k = mesh_devices()
    return k >= 2 and n_ops >= route_min_ops() and n_ops % k == 0


def routed_materialize(arrays: Dict, hints, device=None) -> NodeTable:
    """``merge.materialize`` or the sharded path, per :func:`enabled_for`:
    the same columns and hint mode give the same table either way."""
    if enabled_for(int(arrays["kind"].shape[0])):
        return materialize(arrays, hints=hints, device=device)
    return merge_mod.materialize(arrays, hints=hints, device=device)


def stats() -> dict:
    """Routing counters: merges, devices (the last width), routed_ops,
    enabled, min_ops, halo_rows."""
    with _STATS_LOCK:
        out = dict(_STATS)
    out["enabled"] = route_on()
    out["min_ops"] = route_min_ops()
    out["halo_rows"] = HALO
    return out


# ---- the trace audit of the sharded merge ---------------------------------

def audit_opsaxis(ops: Dict, k: Optional[int] = None,
                  hints="exhaustive", device=None) -> dict:
    """The ops-axis record every bench row carries: one sharded merge of
    ``ops`` (padded and placed as :func:`materialize` does, not counted
    in :func:`stats`) run under the trace audit (``utils.chainaudit``) —
    {devices, shard_width, shard_budget, halo_rows, collective_bytes,
    collective_count, leg, ok}.  ``shard_width`` is the widest memory
    pass inside any shard's window; ``ok`` holds it to ``shard_budget``
    = ceil(M/k) + halo.  With one process driving every shard there are
    no collectives: the carry exchange is kernel 5 (``ring_exclusive``),
    and its calls and bytes are what ``collective_count`` and
    ``collective_bytes`` report."""
    return _audit(_Sharded(ops, k, hints, device))[1]


def _audit(run: _Sharded):
    """Run ``run``'s merge under the trace audit: its table and the
    ``opsaxis`` record."""
    with chainaudit.Audit(widest=run.cols["kind"].shape[0]) as a:
        table = run.merge()
    audit = a.result()
    budget = _ceil_div(run.cols["kind"].shape[0] + 2, run.k) + HALO
    return table, {
        "devices": run.k,
        "shard_width": audit.shard_width,
        "shard_budget": budget,
        "halo_rows": HALO,
        "collective_bytes": audit.collective_bytes,
        "collective_count": audit.collective_count,
        "leg": "hinted" if merge_mod.crowding_hinted(
            run.cols, run.hints, run.no_deletes) else "counted",
        "ok": bool(audit.shard_width <= budget),
    }


def arm_audit(on: bool = True) -> None:
    """Ask for the shard audit of the NEXT sharded merge in this process
    (on any thread), forgetting the last one: that merge runs under the
    trace audit, and :func:`audit_last` then returns its record.  One
    merge is audited an arming, so a load run pays the audit's dispatch
    cost once.  ``on=False`` withdraws the request."""
    with _STATS_LOCK:
        _AUDIT["armed"] = on
        if on:
            _AUDIT["last"] = None


def audit_last() -> Optional[dict]:
    """The ``opsaxis`` record (:func:`audit_opsaxis`'s keys) of the last
    sharded merge audited after :func:`arm_audit` — what the load
    generator's report attaches.  None when none was."""
    with _STATS_LOCK:
        last = _AUDIT["last"]
    return None if last is None else dict(last)
