"""Run-time trace audit: counts the device ops, memory passes, kernel
calls and host syncs of one merge, stage by stage.

The port of ``crdt_graph_tpu.utils.chainaudit``.  The reference walks a
jaxpr shape-only and prices its M-wide memory ops with a TPU cost model;
the port's merge has data-dependent control flow (its ``lax.while_loop``
and ``lax.cond`` became Python loops and branches on predicates read back
from the card, ``ops.merge._read``), so there is no trace to walk.  The
audit RUNS the function under a :class:`torch.utils._python_dispatch.
TorchDispatchMode` and counts what it dispatched.  The mode is
thread-local: it sees only the auditing thread's ops, never a WAL-sync or
reactor thread's.

Every aten op dispatched inside the mode becomes one row ``(stage, op,
width, bytes, note)``:

- ``stage``: the merge stage it ran in, 1-7 (the ``probe=`` cuts of
  ``ops.merge``: resolution; node frames and local validity; validity
  cascade and cycles; deletes; NSA chase, sibling sort and Euler tour;
  run contraction, Wyllie doubling and expansion; ranks, orders and
  statuses), 0 outside a merge (column uploads, read-backs);
- ``op``: the aten op's name; a kernel wrapper's name for a kernel call;
  ``[mask]`` marks an index or index-put through a boolean mask,
  ``[d2h]`` / ``[h2d]`` a copy to or from the host, ``[read]`` the
  scalar read of ``merge._read``;
- ``width``: the random/serial access width: the index count of a gather
  or scatter, the swept axis of a sort or scan, the longest output axis
  of a kernel call, the largest operand of any other op;
- ``bytes``: every tensor operand and result, once (0 for a view);
- ``note``: ``"loop"`` inside one of the merge's data-dependent loops
  (the fixpoint chases, the NSA chase, binary lifting, the Wyllie
  doubling: the reference's ``"scan-body"``), ``"shard"`` inside an
  ops-axis shard's window (the reference's ``[shard]`` path tag),
  ``"hints"`` inside a merge's derivation of its slot hints on the
  device (``ops.merge._derive_slot_hints``, before stage 1), else
  ``""``.

What counts as a memory pass carries over from the reference: gathers
(``index``, ``index_select``, ``gather``, ``take``), scatters
(``index_put_``, ``scatter*``, ``index_add_``, ``index_reduce_``), sorts
and scans (``cumsum``, ``cummax``, ``cummin``, ``cumprod``), and each
hand-written kernel's call as ONE op, whether it launched its CUDA kernel
or, on the CPU, ran its twin (the twin's own ops are not counted, so a
CPU audit and a card audit give the same rows).  An op is M-wide at
``width >= threshold`` (default a quarter of the widest leading input
axis, or of the widest merge: a batch's documents times its rows);
``compact_floor <= width < threshold`` is the compacted-stage bucket
(default ``threshold // 16``).  A batch of documents (``ops.merge`` on
``[B, N]`` columns, ``parallel.mesh.batched_materialize``) is one merge
with its document count: its rows are one chain, whatever B is.

Host syncs are counted by op name, the same on either device: the scalar
read (``_local_scalar_dense``, what ``.item()`` and ``merge._read``
become), every copy to the host, and the ops whose output size depends
on the data, which synchronise on a card (``nonzero``,
``masked_select``, ``unique*``, ``repeat_interleave``, an index or
index-put through a boolean mask).  ``hidden_syncs`` are those that are
not a counted ``merge._read``.

The reference's v5e price (6 ms an M-wide op, its 70 ms cap) does not
carry over; the port's budgets below are its own, set from counts taken
on the card.

    python -m crdt_graph_tpu_torch.utils.chainaudit [--device cpu] \
        [--ops N] [--del-every K] [config ...]

prints the audit of each config (default 5) on each resolution leg its
columns allow (the vouched slot-hinted leg, the ranked, linked and
joined ones): its summary, its counts by stage and every memory pass
and sync; on the card unless ``--device`` names another device;
``--ops`` cuts array configs 5-8; ``--del-every 16`` gives config 5 a
delete of every 16th node (the main path's deletes batch).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from . import profiling

# M-wide op classes by aten name (overload packet)
_GATHERS = frozenset(("index", "index_select", "gather", "take"))
_SCATTERS = frozenset(("index_put", "index_put_", "_index_put_impl_",
                       "index_add", "index_add_", "index_reduce",
                       "index_reduce_"))
_SORTS = frozenset(("sort", "argsort"))
_SCANS = frozenset(("cumsum", "cumsum_", "cummax", "cummin", "cumprod",
                    "cumprod_", "_cummax_helper", "_cummin_helper"))
# ops that wait for the device on a card: their result goes to the host,
# or their output size depends on the data
_SYNCS = frozenset(("_local_scalar_dense", "nonzero", "masked_select",
                    "_unique", "_unique2", "unique_dim",
                    "unique_consecutive", "unique_dim_consecutive",
                    "repeat_interleave", "equal", "is_nonzero"))
_COPIES = frozenset(("_to_copy", "copy_", "copy"))
# allocations: no device work of their own
_ALLOCS = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                     "new_empty_strided"))
# the ops-axis carry exchange: on one card kernel 5 stands where the
# reference's collectives stand, billed by bytes, not as a memory op
_COLLECTIVES = frozenset(("ring_exclusive",))
# the kernel wrappers (:func:`kernel_call` registers each)
_KERNELS: set = set()

# Budgets of one merge, held by :meth:`ChainAudit.summary`'s ``ok`` (a
# run of several merges is held to their sum).  The fast-path budget is
# by resolution leg (``merge.select_leg``: "slot" is the vouched
# slot-hinted leg, the engine's own ingest; the others rank, link or
# join the hints) and by whether the merge runs its delete stage (a
# batch or a document log with any Delete: the stage's cascade adds its
# own passes); the sync budget holds the merge's host syncs outside its
# loops, any leg (a caller's syncs around the merges are reported as
# ``outer_syncs``, not budgeted: a served 1M commit's chunks add ~3
# copies to the host each on the card).  Each is the largest count measured on the card (``python -m
# crdt_graph_tpu_torch.utils.chainaudit 3 4 5 6 7 8``, every leg; and
# the main path's deletes batch, config 5 plus a delete of every 16th
# node at 1,062,500 ops, in ``chip_smoke.py``; NVIDIA H100 80GB HBM3,
# 700.00 W) over the configs at or above the sampler's 65,536-op floor,
# so one more pass or read fails it.  Without deletes the largest is
# config 7's (the fragmented comb), with them configs 4's and the
# deletes batch's (equal on every leg); syncs 7 (config 3, rank and
# link legs).
FAST_PATH_BUDGETS = {        # leg: (no delete stage, delete stage)
    "slot": (18, 24),
    "rank": (32, 35),
    "link": (36, 39),
    "join": (33, 36),
}
SYNC_BUDGET = 7
# M-wide passes of one derivation of a merge's slot hints on the device
# (``ops.slot_hints.derive``): a fixed chain with no loop, 17 passes, 20
# with its crowding pre-pass over paths wider than one column (the same
# count on either device: no kernel call).  Counted apart from the
# merge's fast path, and held to this budget per derivation.
HINT_PASS_BUDGET = 20

_tls = threading.local()


class _Run:
    """The state of one audit on its thread: the rows so far, and where
    the audited code stands (stage, loop and shard depth, suppression
    inside a kernel call)."""

    def __init__(self) -> None:
        self.rows: List[Tuple[int, str, int, int, str]] = []
        self.stage = 0
        self.loop = 0
        self.shard = 0
        self.hints = 0
        self.derived = 0
        self.suppress = 0
        self.pending_read = False
        self.legs: List[str] = []
        self.deletes: List[bool] = []
        self.docs: List[int] = []
        self.widest = 0

    def note(self) -> str:
        return "shard" if self.shard else "loop" if self.loop else \
            "hints" if self.hints else ""

    def add(self, op: str, width: int, nbytes: int) -> None:
        self.rows.append((self.stage, op, int(width), int(nbytes),
                          self.note()))


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    """Bytes of the distinct tensors of ``ts`` (an in-place op's result
    is its operand: counted once)."""
    seen = {id(t): t for t in ts}
    return sum(t.numel() * t.element_size() for t in seen.values())


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _index_width(indices) -> int:
    """Broadcast element count of an advanced index's tensors (None
    entries are whole axes)."""
    shapes = [t.shape for t in indices if isinstance(t, torch.Tensor)]
    return _numel(torch.broadcast_shapes(*shapes)) if shapes else 0


def _width(name: str, args, kwargs, out) -> int:
    if name in ("index", "index_put", "index_put_", "_index_put_impl_"):
        return _index_width(args[1])
    if name in ("index_select", "gather", "index_add", "index_add_",
                "index_reduce", "index_reduce_") or \
            name.startswith("scatter"):
        return int(args[2].numel())
    if name == "take":
        return int(args[1].numel())
    if name in _SORTS or name in _SCANS:
        x = args[0]
        dim = args[1] if len(args) > 1 and isinstance(args[1], int) \
            else kwargs.get("dim", -1)
        return int(x.shape[dim]) if x.dim() else 1
    return max((t.numel() for t in _tensors(args) + _tensors(out)),
               default=0)


def _op_name(name: str, args, kwargs, out) -> str:
    """The row's op name, with the tag that classifies a sync or copy."""
    if name in ("index", "index_put", "index_put_", "_index_put_impl_"):
        if any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
               for t in args[1]):
            return name + "[mask]"
    elif name in _COPIES:
        src = args[1] if name != "_to_copy" else args[0]
        dst = out if name == "_to_copy" else args[0]
        if isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor):
            if dst.device.type == "cpu" and src.device.type != "cpu":
                return name + "[d2h]"
            # a 0-d host operand is a kernel argument, not a transfer
            if dst.device.type != "cpu" and src.device.type == "cpu" \
                    and src.dim():
                return name + "[h2d]"
    elif name == "repeat_interleave" and \
            kwargs.get("output_size") is not None:
        return name + "[sized]"
    return name


class _Mode(TorchDispatchMode):
    """Turns every aten op the auditing thread dispatches into a row."""

    def __init__(self, run: _Run) -> None:
        super().__init__()
        self.run = run

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        run = self.run
        if run.suppress or func.namespace != "aten":
            return out
        name = func._overloadpacket.__name__
        if func.is_view:
            run.add(name, 0, 0)
            return out
        op = _op_name(name, args, kwargs, out)
        if name == "_local_scalar_dense" and run.pending_read:
            run.pending_read = False
            op += "[read]"
        run.add(op, _width(name, args, kwargs, out),
                _nbytes(_tensors(args) + _tensors(out)))
        return out


# ---- hooks: the audited code marks where it stands ------------------------
# Each is one thread-local lookup when no audit runs on the thread (a
# stage marker adds one boolean call: whether a profiler records).

def _active() -> Optional[_Run]:
    return getattr(_tls, "run", None)


def running() -> bool:
    """True while an audit runs on this thread."""
    return _active() is not None


def begin_merge(n: int, leg: str, deletes: bool, docs: int = 1) -> None:
    """A merge of ``n`` op rows on resolution leg ``leg`` starts (stage
    1); ``deletes``: it runs its delete stage.  A batch of ``docs``
    documents of ``n`` rows each is ONE merge: its ops sweep ``docs * n``
    elements, so that is its width."""
    run = _active()
    if run is not None:
        run.legs.append(leg)
        run.deletes.append(bool(deletes))
        run.docs.append(int(docs))
        run.widest = max(run.widest, int(n) * int(docs))
        run.stage = 1
    if profiling.recording():
        profiling.phase("merge.stage1")


def stage(k: int) -> None:
    """The merge enters stage ``k`` (0: it ended).  While a profiler
    records, each stage is also a span (``merge.stage<k>``, a
    :func:`utils.profiling.phase`) that ends at the next marker."""
    run = _active()
    if run is not None:
        run.stage = k
    if k == 0 or profiling.recording():
        profiling.phase(f"merge.stage{k}" if k else None)


def note_read() -> None:
    """``merge._read`` is about to read a scalar: tag that read."""
    run = _active()
    if run is not None:
        run.pending_read = True


@contextlib.contextmanager
def loop():
    """Rows inside carry ``note="loop"``: one of the merge's
    data-dependent loops."""
    run = _active()
    if run is None:
        yield
        return
    run.loop += 1
    try:
        yield
    finally:
        run.loop -= 1


@contextlib.contextmanager
def hints():
    """Rows inside carry ``note="hints"``: one derivation of a merge's
    slot hints on the device."""
    run = _active()
    if run is None:
        yield
        return
    run.hints += 1
    run.derived += 1
    try:
        yield
    finally:
        run.hints -= 1


@contextlib.contextmanager
def shard():
    """Rows inside carry ``note="shard"``: one ops-axis shard's work."""
    run = _active()
    if run is None:
        yield
        return
    run.shard += 1
    try:
        yield
    finally:
        run.shard -= 1


def _kernel_width(t: torch.Tensor, docs: bool) -> int:
    """A kernel row's width from one output: its longest axis, times the
    documents of a batched kernel's leading axis."""
    if docs and t.dim() > 1:
        return int(t.shape[0]) * max(t.shape[1:])
    return max(t.shape, default=1)


def kernel_call(fn):
    """Decorator of a kernel wrapper: under an audit, each call is ONE
    row named after the wrapper (its width the longest output axis; for
    a ``*_batched`` wrapper, whose outputs lead with the document axis,
    that axis times the longest other), and nothing it dispatches inside
    (allocations on the card, the twin's ops on the CPU) is counted."""
    name = fn.__name__
    docs = name.endswith("_batched")
    _KERNELS.add(name)

    @functools.wraps(fn)
    def call(*args, **kwargs):
        run = _active()
        if run is None or run.suppress:
            return fn(*args, **kwargs)
        run.suppress += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            run.suppress -= 1
        outs = _tensors(out)
        run.add(name, max((_kernel_width(t, docs) for t in outs),
                          default=0),
                _nbytes(_tensors((args, kwargs)) + outs))
        return out
    return call


# ---- the result -------------------------------------------------------------

def _klass(op: str) -> Optional[str]:
    """The memory-pass class of a row's op, or None."""
    base = op.split("[", 1)[0]
    if op.endswith("[mask]"):
        return None          # a sync; its width is the data's
    if base in _KERNELS and base not in _COLLECTIVES:
        return "kernel"
    if base in _GATHERS:
        return "gather"
    if base in _SCATTERS or base.startswith("scatter"):
        return "scatter"
    if base in _SORTS:
        return "sort"
    if base in _SCANS:
        return "scan"
    return None


def _is_sync(op: str) -> bool:
    base = op.split("[", 1)[0]
    return (base in _SYNCS and not op.endswith("[sized]")) or \
        op.endswith("[mask]") or op.endswith("[d2h]")


def _is_device_op(op: str, nbytes: int, width: int) -> bool:
    """False for views and bare allocations (no device work)."""
    return not (nbytes == 0 and width == 0) and \
        op.split("[", 1)[0] not in _ALLOCS


@dataclasses.dataclass
class ChainAudit:
    """Result of :func:`count_mwide`.

    ``fast_path``: M-wide memory passes outside the merge's loops (it
    does not grow with log M) and outside its derivation of its slot
    hints, which ``hint_passes`` counts (``derived`` derivations ran).
    ``static``: every M-wide pass that ran, loop trips included.
    ``rows``: ``(stage, op, width, bytes, note)`` per dispatched op, in
    order.  ``legs``: the resolution leg of each merge the run held and
    ``deletes`` whether it ran its delete stage (the budgets are per
    merge, by both)."""
    fast_path: int
    static: int
    threshold: int
    rows: List[Tuple[int, str, int, int, str]]
    width_ref: int = 0
    compact_floor: int = 0
    # which sibling-crowding leg ran (``merge.crowding_hinted``: "hinted"
    # = the crowd columns replaced the count, "counted")
    crowding_leg: str = ""
    legs: List[str] = dataclasses.field(default_factory=list)
    deletes: List[bool] = dataclasses.field(default_factory=list)
    docs: List[int] = dataclasses.field(default_factory=list)
    derived: int = 0

    @property
    def merges(self) -> int:
        return len(self.legs)

    @property
    def budget(self) -> int:
        """The fast-path budget of the run's merges, summed (a slot-leg
        merge's without deletes when it held none)."""
        return sum(FAST_PATH_BUDGETS[leg][d]
                   for leg, d in zip(self.legs, self.deletes)) or \
            FAST_PATH_BUDGETS["slot"][0]

    def _mwide(self, r) -> bool:
        return _klass(r[1]) is not None and r[2] >= self.threshold

    @property
    def hint_passes(self) -> int:
        """M-wide passes of the run's slot-hint derivations."""
        return sum(1 for r in self.rows if r[4] == "hints" and self._mwide(r))

    @property
    def compact_fast(self) -> int:
        return sum(1 for r in self.rows
                   if _klass(r[1]) is not None and r[4] != "loop"
                   and self.compact_floor <= r[2] < self.threshold)

    @property
    def loop_ops(self) -> int:
        """M-wide passes inside the merge's loops (their trips)."""
        return sum(1 for r in self.rows if r[4] == "loop" and self._mwide(r))

    @property
    def host_syncs(self) -> int:
        return sum(1 for r in self.rows if _is_sync(r[1]))

    def _outer(self, r) -> bool:
        """A row outside every merge of a run that held merges (stage
        0): the caller's work around them."""
        return bool(self.legs) and not r[0]

    @property
    def fast_syncs(self) -> int:
        """Host syncs of the merges outside their loops (the loops' reads
        grow with their trips, as their passes do): what the sync budget
        holds."""
        return sum(1 for r in self.rows if _is_sync(r[1])
                   and r[4] != "loop" and not self._outer(r))

    @property
    def outer_syncs(self) -> int:
        """Host syncs outside the merges (a served commit's read-backs
        around them, on a card its copies to the host): counted in
        ``host_syncs``, not held to the merges' budget."""
        return sum(1 for r in self.rows
                   if _is_sync(r[1]) and self._outer(r))

    @property
    def read_syncs(self) -> int:
        """The syncs that are counted ``merge._read`` calls."""
        return sum(1 for r in self.rows if r[1].endswith("[read]"))

    @property
    def hidden_syncs(self) -> int:
        """Syncs that ``merge.host_syncs`` does not count."""
        return self.host_syncs - self.read_syncs

    @property
    def device_ops(self) -> int:
        """Dispatched ops that do device work (views and bare
        allocations excluded), a kernel call as one."""
        return sum(1 for r in self.rows if _is_device_op(r[1], r[3], r[2]))

    @property
    def kernel_calls(self) -> Dict[str, int]:
        return dict(collections.Counter(
            r[1] for r in self.rows if r[1] in _KERNELS))

    @property
    def bytes(self) -> int:
        return sum(r[3] for r in self.rows)

    # -- the ops-axis accounting (parallel/opsaxis.py) ----------------------

    @property
    def shard_width(self) -> int:
        """Widest memory pass inside any shard's window (compacted
        stages included): what the ops-axis budget holds at
        ceil(M/k) + halo."""
        return max((r[2] for r in self.rows
                    if r[4] == "shard" and _klass(r[1]) is not None
                    and r[2] >= self.compact_floor), default=0)

    @property
    def collective_bytes(self) -> int:
        """Bytes of the carry exchange (kernel 5's calls: on one card it
        stands where the reference's collectives stand)."""
        return sum(r[3] for r in self.rows if r[1] in _COLLECTIVES)

    @property
    def collective_count(self) -> int:
        return sum(1 for r in self.rows if r[1] in _COLLECTIVES)

    def by_stage(self) -> Dict[int, Dict[str, int]]:
        """Per stage: device ops, M-wide passes (outside loops), loop
        passes, kernel calls, ``merge._read`` syncs, hidden syncs."""
        out: Dict[int, Dict[str, int]] = {}
        for r in self.rows:
            s = out.setdefault(r[0], dict.fromkeys(
                ("device_ops", "mwide", "loop_ops", "kernel_calls",
                 "read_syncs", "hidden_syncs"), 0))
            s["device_ops"] += _is_device_op(r[1], r[3], r[2])
            if self._mwide(r):
                s["loop_ops" if r[4] == "loop" else "mwide"] += 1
            s["kernel_calls"] += r[1] in _KERNELS
            if r[1].endswith("[read]"):
                s["read_syncs"] += 1
            elif _is_sync(r[1]):
                s["hidden_syncs"] += 1
        return dict(sorted(out.items()))

    def table(self) -> str:
        """The header counts, then every memory pass and sync in order."""
        lines = [f"threshold {self.threshold} | fast_path {self.fast_path}"
                 f" | static {self.static} | compact {self.compact_fast} |"
                 f" host_syncs {self.host_syncs} (hidden "
                 f"{self.hidden_syncs}) | device_ops {self.device_ops} |"
                 f" merges {self.merges} {self.legs}"]
        for st, op, width, nb, note in self.rows:
            k = _klass(op)
            if k is None and not _is_sync(op):
                continue
            tag = "sync" if k is None else "M-wide" if width >= \
                self.threshold else "compact" if width >= \
                self.compact_floor else ""
            lines.append(f"  {st} {op:28s} {width:>10d} {nb:>12d}B "
                         f"{tag:8s} {note}")
        return "\n".join(lines)

    def summary(self) -> dict:
        """The stats record the runner's rows, the flight recorder's
        sampled commits and the opsaxis report carry."""
        sync_budget = SYNC_BUDGET * max(1, self.merges)
        hint_budget = HINT_PASS_BUDGET * self.derived
        out = {
            "fast_path": self.fast_path,
            "static": self.static,
            "budget": self.budget,
            "sync_budget": sync_budget,
            "hint_passes": self.hint_passes,
            "hint_budget": hint_budget,
            "ok": bool(self.fast_path <= self.budget and
                       self.fast_syncs <= sync_budget and
                       self.hint_passes <= hint_budget),
            "host_syncs": self.host_syncs,
            "fast_syncs": self.fast_syncs,
            "outer_syncs": self.outer_syncs,
            "hidden_syncs": self.hidden_syncs,
            "device_ops": self.device_ops,
            "kernel_calls": self.kernel_calls,
            "loop_ops": self.loop_ops,
            "bytes": self.bytes,
            "merges": self.merges,
            "docs": sum(self.docs),
            "legs": sorted(set(self.legs)),
            "deletes": any(self.deletes),
        }
        if self.crowding_leg:
            out["crowding_leg"] = self.crowding_leg
        return out


class Audit:
    """``with Audit() as a: ...; a.result()`` — audit whatever the block
    runs on this thread.  ``threshold`` defaults to a quarter of
    ``widest`` (or, when that is 0, of the widest merge the block ran)."""

    def __init__(self, threshold: Optional[int] = None,
                 compact_floor: Optional[int] = None,
                 widest: int = 0) -> None:
        self.threshold = threshold
        self.compact_floor = compact_floor
        self.widest = widest
        self._run = _Run()
        self._mode = _Mode(self._run)
        self._saved = None

    def __enter__(self) -> "Audit":
        self._saved = _active()
        _tls.run = self._run
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        try:
            self._mode.__exit__(*exc)
        finally:
            _tls.run = self._saved

    def result(self) -> ChainAudit:
        run = self._run
        widest = self.widest or run.widest or 1
        threshold = self.threshold if self.threshold is not None else \
            max(widest // 4, 1)
        floor = self.compact_floor if self.compact_floor is not None \
            else max(threshold // 16, 1)
        rows = list(run.rows)
        audit = ChainAudit(fast_path=0, static=0, threshold=threshold,
                           rows=rows, width_ref=widest,
                           compact_floor=floor, legs=list(run.legs),
                           deletes=list(run.deletes), docs=list(run.docs),
                           derived=run.derived)
        mwide = [r for r in rows if audit._mwide(r)]
        audit.fast_path = sum(1 for r in mwide
                              if r[4] not in ("loop", "hints"))
        audit.static = len(mwide)
        return audit


def _widest(args) -> int:
    """The widest leading axis among ``args``' arrays and tensors."""
    w = 0
    for leaf in tree_leaves(args):
        shape = getattr(leaf, "shape", ())
        if len(shape):
            w = max(w, int(shape[0]))
    return w


def count_mwide(fn, *args, threshold: Optional[int] = None,
                compact_floor: Optional[int] = None) -> ChainAudit:
    """Run ``fn(*args)`` under an audit and count what it dispatched.

    ``threshold``: the least width an M-wide pass has; default a quarter
    of the widest leading axis among ``args`` (of the widest merge the
    call ran when ``args`` hold no array).  ``compact_floor``: the least
    width of the compacted-stage bucket; default ``threshold // 16``."""
    with Audit(threshold, compact_floor, _widest(args)) as a:
        fn(*args)
    return a.result()


def audit_materialize(ops: Dict[str, Any], hints: Optional[str],
                      no_deletes: bool, device=None,
                      threshold: Optional[int] = None) -> ChainAudit:
    """Audit one merge of an op-column dict on ``device`` (default: the
    card).  The columns the merge reads are copied to the device before
    the audit starts, so the rows are the merge's alone and the same on
    either device."""
    from ..convert import ops_from_numpy
    from ..ops import merge

    dev = merge.resolve_device(device)
    cols = ops_from_numpy(ops, dev)
    audit = count_mwide(
        lambda c: merge._materialize(c, hints, dev, no_deletes), cols,
        threshold=threshold)
    audit.crowding_leg = "hinted" if merge.crowding_hinted(
        ops, hints, no_deletes) else "counted"
    return audit


def audit_summary(ops: Dict[str, Any], hints: Optional[str],
                  no_deletes: bool, device=None) -> dict:
    """:func:`audit_materialize` → the bench stats record."""
    return audit_materialize(ops, hints, no_deletes, device).summary()


def audit_packed_summary(p, device=None) -> dict:
    """The audit of one serving batch (a ``PackedOps``) as the replica
    engine merges it: its columns, in the hint mode the engine elects for
    it (exhaustive for a vouched batch, which derives its slot hints on
    the device; verified auto otherwise).  The summary a sampled flight
    record carries when the commit's own merge could not be audited (a
    grouped or remote round)."""
    from ..ops import merge
    cols = p.columns()
    hints = "exhaustive" if p.hints_vouched else None
    return audit_summary(cols, hints, merge.host_no_deletes(cols["kind"]),
                         device)


def _main(argv=None) -> int:  # pragma: no cover - CLI convenience
    import argparse
    import json

    import numpy as np

    from ..bench import workloads
    from ..codec import packed as packed_mod
    from ..ops import merge
    ap = argparse.ArgumentParser(
        prog="python -m crdt_graph_tpu_torch.utils.chainaudit",
        description="Audit the merge of benchmark configs: memory passes, "
                    "kernel calls and host syncs by stage.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--ops", type=int, default=None,
                    help="cut array configs (5-8) to this many ops")
    ap.add_argument("--del-every", type=int, default=None,
                    help="config 5 with a delete of every Nth node "
                         "(the main path's deletes batch at 16)")
    ap.add_argument("configs", nargs="*", type=int)
    opts = ap.parse_args(argv)
    dev = merge.resolve_device(opts.device)
    for cid in opts.configs or [5]:
        name, gen = workloads.CONFIGS[cid]
        if cid == 5 and opts.del_every:
            raw = workloads.chain_with_deletes(opts.ops or 1_000_000,
                                               opts.del_every, 64)
        else:
            raw = _cut(cid, opts.ops) if opts.ops and cid in _CUTS \
                else gen()
        arrs = raw if isinstance(raw, dict) else \
            packed_mod.pack(raw).arrays()
        no_del = not bool(np.any(np.asarray(arrs["kind"]) == 1))
        for leg, hints, cols in _legs(arrs):
            audit = audit_materialize(cols, hints, no_del, dev)
            print(f"== config {cid} ({name}, {arrs['kind'].shape[0]} ops, "
                  f"leg {leg}, hints={hints or 'auto'}) on {dev}: "
                  f"{json.dumps(audit.summary())}")
            print("   by stage: " + json.dumps(audit.by_stage()))
            print(audit.table())
    return 0


def _legs(arrs: Dict[str, Any]):
    """``(leg, hints, columns)`` for each resolution leg the columns
    allow: the hint mode and the columns that select it."""
    from ..ops import merge
    no_rank = {k: v for k, v in arrs.items() if k != "ts_rank"}
    out = []
    for hints, cols in (("exhaustive", arrs), (None, arrs),
                        (None, no_rank), ("join", arrs)):
        leg = merge.select_leg(cols, hints)
        if leg not in [x[0] for x in out]:
            out.append((leg, hints, cols))
    return out


# the array configs (5-8) by generator name and its leading arguments
_CUTS = {5: ("chain_workload", 64), 6: ("descending_chains", 4096),
         7: ("comb_pairs",), 8: ("deep_paths", 64)}


def _cut(cid: int, n: int) -> Dict[str, Any]:
    """Array config ``cid`` generated at ``n`` ops."""
    from ..bench import workloads
    fn, *lead = _CUTS[cid]
    return getattr(workloads, fn)(*lead, n)


if __name__ == "__main__":  # pragma: no cover
    import importlib
    import sys
    # the package's own copy of this module: the merge's hooks report
    # to it, not to this ``__main__`` copy
    sys.exit(importlib.import_module(__spec__.name)._main(sys.argv[1:]))
