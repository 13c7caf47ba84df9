"""Packed operation arrays: the host↔device boundary of the TPU engine.

An operation batch becomes a struct-of-arrays with static shapes so the merge
kernel can be traced once and reused.  Values never cross the boundary — the
kernel is payload-oblivious; each Add carries an index into a host-side value
table (``value_ref``), and the merged node table refers back into it.

Layout (N = padded op count, D = maximum path length):

- ``kind``       i8[N]   — 0 add, 1 delete, 2 padding
- ``ts``         i64[N]  — add: the new node's timestamp; delete: the
                           target's timestamp (= last path element)
- ``parent_ts``  i64[N]  — second-to-last path element, 0 at root level
- ``anchor_ts``  i64[N]  — add: last path element (0 = branch-head sentinel)
- ``depth``      i32[N]  — path length
- ``paths``      i64[N,D] — the full claimed path, zero-padded; used by the
                            kernel to validate ops against materialised
                            ancestor paths
- ``value_ref``  i32[N]  — index into the host value table, -1 if none
- ``pos``        i32[N]  — position in the original batch order; the kernel
                           uses it for first-arrival-wins dedup and for
                           sequential-parity statuses
- ``parent_pos`` i32[N]  — batch position of the Add that created this
                           op's tree parent (-1 = root level / not in
                           batch); ingest-resolved LINK HINT, see below
- ``anchor_pos`` i32[N]  — adds: batch position of the anchor's Add
                           (-1 = sentinel / not in batch)
- ``target_pos`` i32[N]  — deletes: batch position of the target's Add
- ``ts_rank``    i32[N]  — adds: rank of this op's timestamp among the
                           batch's UNIQUE add timestamps, ascending
                           (-1 = non-add / unranked); RANK HINT — lets
                           the kernel assign timestamp-ordered slots
                           without its full-width device sort

Timestamps are int64: ``replica_id * 2**32 + counter`` exceeds int32 by
design (core/timestamp.py).  Shapes are padded to buckets (powers of two) so
jit caches stay small.

**Link hints.**  The host walks every op once at ingest anyway, so it
resolves timestamp references (anchor / parent / delete target) to batch
POSITIONS here, with one dict — and the device kernel then turns each
reference into one verified int32 gather instead of re-joining 4 queries
per op against the sorted timestamp axis on every merge (the join was a
top cost of the round-2 kernel on v5e).  Hints are advisory: the kernel
verifies ``ts[hint] == referenced_ts`` on device and falls back to the
full sort-join if ANY hint fails to verify, so a wrong or missing hint
can never change semantics, only speed.  ``-1`` means "not resolved";
raw-array callers that provide no hint columns at all get the join path.

**Rank hints.**  Same economics, applied to the kernel's OTHER use of
the timestamp sort: assigning each unique add a dense slot id whose
order is timestamp order.  ``ts_rank`` carries that rank from ingest
(one vectorized ``np.unique`` here), so the kernel can scatter ops
straight into their slots and skip its full-width device sort — its
single most expensive stage on v5e.  Advisory like link hints: the
kernel re-derives the invariants on device (dense used-slot prefix,
strictly increasing slot timestamps, every add ranked, duplicate
timestamps agreeing) and any violation sends the whole batch down the
sort path, so wrong ranks cost speed, never correctness.  On the host a
rank is sorted only once: a union's rank (:func:`concat_many`) and a
part's timestamp index (:meth:`PackedOps.index`) read the order from
the parts' ``ts_rank`` where an O(n) check proves it the adds' rank.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core import operation as op_mod
from ..core.operation import Add, Batch, Delete, Operation
from ..utils import profiling
from . import json_codec

KIND_ADD = 0
KIND_DELETE = 1
KIND_PAD = 2

DEFAULT_MAX_DEPTH = 16

# Timestamps at or above this are reserved as kernel sentinels.  The protocol
# value space (replica_id * 2**32 + counter) reaches it only for replica ids
# >= 2**30 — pack() rejects those loudly rather than letting the kernel treat
# them as padding.
MAX_TS = 2**62

_I64_MIN, _I64_MAX = -2**63, 2**63 - 1


@dataclasses.dataclass
class PackedOps:
    """A batch of operations as fixed-shape arrays plus a host value table."""

    kind: np.ndarray
    ts: np.ndarray
    parent_ts: np.ndarray
    anchor_ts: np.ndarray
    depth: np.ndarray
    paths: np.ndarray
    value_ref: np.ndarray
    pos: np.ndarray
    values: List[Any]
    num_ops: int  # real (unpadded) op count
    # link hints (see module docstring); default -1 = join fallback
    parent_pos: Optional[np.ndarray] = None
    anchor_pos: Optional[np.ndarray] = None
    target_pos: Optional[np.ndarray] = None
    # rank hint (see module docstring); default -1 = device-sort fallback
    ts_rank: Optional[np.ndarray] = None
    # provenance: True when the LINK hint columns are known-complete
    # (every in-batch reference resolved) because this object came from
    # pack/concat/parse_pack.  Callers may then use the kernel's
    # cond-free "exhaustive" mode; objects with defaulted hint columns
    # (e.g. restored old checkpoints) must keep the verified auto mode.
    # ts_rank needs no flag — post_init computes it from kind/ts.
    hints_vouched: bool = False
    # host-side ts -> first add position index (:class:`TsIndex`),
    # cached so engine concat chains don't rebuild it per bulk apply
    # (not a device field)
    ts_index: Optional["TsIndex"] = dataclasses.field(default=None,
                                                      repr=False)
    # lazily derived SLOT-hint columns (see derive_slot_hints); cached
    # per object, invalidated by rebuild_hints (not a wire field)
    slot_hints: Optional[dict] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        cap = self.capacity
        if self.parent_pos is None:
            self.parent_pos = np.full(cap, -1, dtype=np.int32)
        if self.anchor_pos is None:
            self.anchor_pos = np.full(cap, -1, dtype=np.int32)
        if self.target_pos is None:
            self.target_pos = np.full(cap, -1, dtype=np.int32)
        if self.ts_rank is None:
            self.ts_rank = compute_ts_rank(self.kind, self.ts)

    @property
    def capacity(self) -> int:
        return int(self.kind.shape[0])

    @property
    def max_depth(self) -> int:
        return int(self.paths.shape[1])

    def arrays(self) -> dict:
        """The reference's device-bound fields (everything but the value
        table): :meth:`columns` plus, for a vouched batch, the SLOT-hint
        columns derived on the host (:func:`derive_slot_hints`, cached on
        the object).  Unvouched batches omit them (the kernel's verified
        auto mode could not trust them).  The port's merges take
        :meth:`columns` and derive the slot hints they lack on the
        device; this form serves what must equal the reference's (the
        merge tier's request digest) and callers that hold given hints."""
        out = self.columns()
        if self.hints_vouched:
            if self.slot_hints is None:
                self.slot_hints = derive_slot_hints(out)
            out.update(self.slot_hints)
        return out

    def columns(self) -> dict:
        """The packed columns with the link and rank hints, without the
        derived slot hints (an exhaustive merge derives those on its
        device)."""
        return {
            "kind": self.kind, "ts": self.ts, "parent_ts": self.parent_ts,
            "anchor_ts": self.anchor_ts, "depth": self.depth,
            "paths": self.paths, "value_ref": self.value_ref, "pos": self.pos,
            "parent_pos": self.parent_pos, "anchor_pos": self.anchor_pos,
            "target_pos": self.target_pos, "ts_rank": self.ts_rank,
        }

    def index(self) -> "TsIndex":
        """ts → first add batch position (built once, then cached): from
        the adds' ``ts_rank`` where :func:`_rank_keys` proves it their
        rank, else by a sort (also where an add has ``ts <= 0``: the
        index holds it, the rank does not)."""
        if self.ts_index is None:
            with profiling.span("packed.ts_index"):
                add_rows = _add_rows(self.kind, self.num_ops)
                profiling.count("packed.index_rows", int(add_rows.size))
                add_ts = self.ts[add_rows]
                rank = self.ts_rank[add_rows].astype(np.intp)
                keys = None
                if not add_ts.size or add_ts.min() > 0:
                    keys = _rank_keys(add_ts, rank, _ONE_RUN)
                if keys is None:
                    profiling.count("packed.rank_resorted",
                                    int(add_rows.size))
                    self.ts_index = TsIndex.of_adds(self.ts, add_rows)
                else:
                    profiling.count("packed.rank_reused", int(add_rows.size))
                    self.ts_index = TsIndex.of_rank(keys, rank, add_rows)
        return self.ts_index


class TsIndex:
    """A batch's add timestamps → the first add row carrying each, as two
    sorted arrays: ``keys`` (the unique add timestamps, ascending, int64)
    and ``rows`` (each key's first add row, int64).

    Built in one vectorized pass (a sort and a run-length pass): a
    native-parsed million-op batch must not pay a per-op Python loop,
    nor a boxed int per entry, here.  ``get`` answers one timestamp,
    ``lookup`` a whole array of them with one ``searchsorted``."""

    __slots__ = ("keys", "rows")

    def __init__(self, keys: np.ndarray, rows: np.ndarray):
        self.keys = keys
        self.rows = rows

    @classmethod
    def of_adds(cls, ts: np.ndarray, add_rows: np.ndarray) -> "TsIndex":
        """The index of the adds at ``add_rows`` (ascending)."""
        add_ts = ts[add_rows]
        order = np.argsort(add_ts)
        keys = add_ts[order]
        rows = add_rows[order]
        head = np.ones(keys.size, dtype=bool)
        np.not_equal(keys[1:], keys[:-1], out=head[1:])
        if not head.all():
            # duplicate timestamps: the unstable sort left each run's rows
            # in any order, so keep each run's smallest
            starts = np.nonzero(head)[0]
            keys = keys[starts]
            rows = np.minimum.reduceat(rows, starts)
        return cls(keys, rows)

    @classmethod
    def of_rank(cls, keys: np.ndarray, rank: np.ndarray,
                rows: np.ndarray) -> "TsIndex":
        """The index of the adds at ``rows`` (ascending) from their
        timestamps' ``rank`` among ``keys`` (:func:`_rank_keys`), with no
        sort: each key's first row by a scatter."""
        first = np.empty(keys.size, dtype=np.int64)
        first[rank] = rows
        if keys.size < rows.size:
            # duplicate timestamps: which of a rank's rows the scatter
            # left is unspecified, so take each duplicated rank's smallest
            dup = np.bincount(rank, minlength=keys.size)[rank] > 1
            first[rank[dup]] = _I64_MAX
            np.minimum.at(first, rank[dup], rows[dup])
        return cls(keys, first)

    def __len__(self) -> int:
        return int(self.keys.size)

    @property
    def nbytes(self) -> int:
        return self.keys.nbytes + self.rows.nbytes

    def get(self, t: int) -> Optional[int]:
        """The first add row carrying timestamp ``t``, or None."""
        keys = self.keys
        if not keys.size or not _I64_MIN <= t <= _I64_MAX:
            return None
        i = int(np.searchsorted(keys, t))
        if i < keys.size and keys[i] == t:
            return int(self.rows[i])
        return None

    def lookup(self, refs: np.ndarray) -> np.ndarray:
        """:meth:`get` over an int64 array: each ref's first add row, -1
        where no add carries it."""
        refs = np.asarray(refs, dtype=np.int64)
        out = np.full(refs.shape, -1, dtype=np.int64)
        if self.keys.size:
            i = np.searchsorted(self.keys, refs)
            np.minimum(i, self.keys.size - 1, out=i)
            hit = self.keys[i] == refs
            out[hit] = self.rows[i[hit]]
        return out


def _add_rows(kind: np.ndarray, n: int) -> np.ndarray:
    """The add rows among rows ``[0, n)``, ascending."""
    return np.nonzero(kind[:n] == KIND_ADD)[0]


@profiling.span("packed.ts_rank")
def compute_ts_rank(kind: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """Rank of each add's timestamp among the batch's unique add
    timestamps, ascending; -1 for non-add rows.  One vectorized
    ``np.unique`` — the host-side cost that buys the kernel out of its
    full-width device sort (see module docstring, rank hints)."""
    rank = np.full(kind.shape[0], -1, dtype=np.int32)
    add_rows = np.nonzero((kind == KIND_ADD) & (ts > 0))[0]
    if add_rows.size:
        _, inv = np.unique(ts[add_rows], return_inverse=True)
        rank[add_rows] = inv.astype(np.int32)
    return rank


_ONE_RUN = np.zeros(1, dtype=np.intp)


def _rank_keys(ts: np.ndarray, rank: np.ndarray,
               runs: np.ndarray) -> Optional[np.ndarray]:
    """The ascending unique values of each run of ``ts`` (all positive),
    side by side, from each value's claimed ``rank``: its rank among its
    run's values plus the run's first position (``runs``, ascending), by
    one scatter ``keys[rank] = ts``.  None unless the scatter proves
    the keys: every position held, the keys strictly increasing within
    each run, and every row's key its value, so that each rank names its
    value's position (for one run, ``compute_ts_rank``'s rank).  An O(n)
    proof, no sort."""
    if not rank.size:
        return np.zeros(0, dtype=np.int64)
    top = int(rank.max())
    if rank.min() < 0 or top >= rank.size:
        return None
    keys = np.zeros(top + 1, dtype=np.int64)
    keys[rank] = ts
    # a position no row holds keeps its 0, below every value here: keys
    # that start each run above 0 and increase through it hold them all
    starts = runs[runs <= top]
    up = keys[1:] > keys[:-1]
    up[starts[starts > 0] - 1] = True
    if not up.all() or (keys[starts] <= 0).any():
        return None
    if not np.array_equal(keys[rank], ts):
        return None
    return keys


def _union_rank(out: PackedOps, bases: List[int]) -> None:
    """Turn ``out.ts_rank`` (each part's own rank, copied with its rows
    from ``bases``) into the rank ``compute_ts_rank`` gives the union,
    with no sort of the timestamps: the parts' ascending unique
    timestamps laid side by side from their ranks (:func:`_rank_keys`),
    merged (:func:`_merged_ranks`), and each row's rank gathered through
    its part's.  The same few passes for any number of parts.  Where a
    part's rank fails the proof, the union is sorted as
    ``compute_ts_rank`` does."""
    n = out.num_ops
    ranked = (out.kind[:n] == KIND_ADD) & (out.ts[:n] > 0)
    own = out.ts_rank[:n].astype(np.intp)
    own[~ranked] = -1
    # each part's run of keys starts where the runs before it end
    runs = np.zeros(len(bases), dtype=np.intp)
    np.cumsum(np.maximum.reduceat(own, bases)[:-1] + 1, out=runs[1:])
    own += np.repeat(runs, np.diff(bases + [n]))
    rows = slice(0, n) if ranked.all() else np.flatnonzero(ranked)
    ts, claimed = out.ts[rows], own[rows]
    keys = _rank_keys(ts, claimed, runs)
    if keys is None:
        profiling.count("packed.rank_resorted", int(ts.size))
        _, rank = np.unique(ts, return_inverse=True)
    else:
        profiling.count("packed.rank_reused", int(ts.size))
        rank = _merged_ranks(keys, runs)[claimed]
    out.ts_rank[:n] = -1
    out.ts_rank[rows] = rank


def _merged_ranks(keys: np.ndarray, runs: np.ndarray) -> np.ndarray:
    """Each of ``keys``' positions' rank among its distinct values, where
    the keys ascend within each run (first positions ``runs``).  Two
    runs, a state and its delta, merge in O(n) by one ``searchsorted``
    of the shorter into the longer; more runs by one stable sort, which
    finds the runs in order and merges them."""
    to_u = np.empty(keys.size, dtype=np.intp)
    if runs.size > 2:
        order = np.argsort(keys, kind="stable")
        merged = keys[order]
        fresh = np.empty(merged.size, dtype=np.intp)
        fresh[:1] = 1
        np.not_equal(merged[1:], merged[:-1], out=fresh[1:])
        to_u[order] = np.cumsum(fresh) - 1
        return to_u
    cut = int(runs[1])
    a, b = (keys[:cut], to_u[:cut]), (keys[cut:], to_u[cut:])
    (big, big_u), (small, small_u) = (a, b) if cut >= b[0].size else (b, a)
    below = np.searchsorted(big, small)      # big's keys below each small
    if big.size:
        fresh = big[np.minimum(below, big.size - 1)] != small
    else:
        fresh = np.ones(small.size, dtype=bool)
    # a small key sits above its big keys and the fresh small keys
    # before it (a key both hold takes one position); the big keys, in
    # order, take the positions no fresh small key takes
    np.subtract(below + np.cumsum(fresh), fresh, out=small_u)
    held = np.ones(big.size + int(np.count_nonzero(fresh)), dtype=bool)
    held[small_u[fresh]] = False
    big_u[:] = np.flatnonzero(held)
    return to_u


@profiling.span("packed.slot_hints")
def derive_slot_hints(arrs: dict) -> dict:
    """Slot-level hint columns derived from the position hints + ranks —
    the pack philosophy taken to its endpoint: the host already resolved
    every timestamp reference to a batch POSITION and every add to a
    RANK, so composing the two yields the exact values the kernel's
    exhaustive-mode resolution would compute with its gathers
    (merge._res_hint_impl, ``check_ts=False``), precomputed per op.
    With these columns a vouched merge resolves references ELEMENTWISE:
    the resolution-stage M-wide gathers (2 hint gathers + the
    duplicate-election readback + the anchor-sibling slot gather)
    leave the device trace entirely.

    Derived, not wire, columns: every producer's ``arrays()`` computes
    them lazily from the audited base columns, so no codec, checkpoint,
    or native-parser change is needed and ``verify_hints`` keeps
    auditing the single source of truth.  The encodings mirror the
    kernel bit for bit (slot<<1 | found — the ``pf_pack``/``af_pack``
    layout merge._finish already uses):

    - ``parent_sl`` i32[N]: the parent reference's resolved slot+found.
    - ``at_sl``     i32[N]: the fused anchor-or-target resolution
      (anchor for Add rows, own/target ts for Delete rows).
    - ``anchor_psl`` i32[N]: the anchor's OWN parent resolution (the
      canonical anchor row's ``parent_sl``) — what the kernel's
      sibling check read as ``pslot[aslot]``; NULL<<1 when the anchor
      is unresolved/sentinel.
    - ``dup_row``   i8[N]: 1 iff an earlier array row carries the same
      add timestamp (the kernel's first-array-row-wins duplicate
      election, formerly a win-frame readback gather).
    - ``win_row``   i32[N]: the canonical SOURCE ROW per slot — entry k
      is the first array row whose rank is k (IPOS32 when slot k+1 is
      unused), i.e. exactly what the kernel's winner scatter-min
      computed on device.  With it the fused resolution assembles the
      whole ``win`` frame elementwise (concat + sentinels), so the one
      remaining resolution-stage M-wide memory op leaves the trace
      (round 7; utils/chainaudit.py budget).
    - ``parent_row`` i32[N]: the canonical row of the op's RESOLVED
      parent (``win_row`` composed with the parent resolution), -1 when
      the parent is the root or unresolved.  Rides the node-frame plane
      as the second-hop index: the parent's materialised path/depth
      re-derive from its source row instead of a separate ``[M, D+1]``
      gather through ``pslot`` (ops/fused_resolve.py ``plane_rows2``).

    Slot encodings depend on the array CAPACITY (NULL = cap+1): any
    re-pad must recompute them (``pad_arrays`` does).
    """
    kind = arrs["kind"]
    ts = arrs["ts"]
    rank = arrs["ts_rank"]
    n = int(kind.shape[0])
    ROOT, NULL = 0, n + 1
    is_add = kind == KIND_ADD
    # mirror of the kernel's op_slot / _pack_slot_or_neg columns
    has_rank = is_add & (ts > 0) & (ts < MAX_TS) & \
        (rank >= 0) & (rank < n)
    op_slot = np.where(has_rank, rank + 1, NULL).astype(np.int32)
    son = np.where(is_add, op_slot, -1).astype(np.int32)

    def _res(hint, want):
        h = np.clip(hint, 0, n - 1)
        sp = son[h]
        ok = (hint >= 0) & (sp >= 0) & (want > 0) & (want < MAX_TS)
        slot = np.where(want == 0, ROOT,
                        np.where(ok, sp, NULL)).astype(np.int32)
        found = (want == 0) | ok
        return ((slot << 1) | found).astype(np.int32)

    at_pos = np.where(is_add, arrs["anchor_pos"], arrs["target_pos"])
    at_ts = np.where(is_add, arrs["anchor_ts"], ts)
    parent_sl = _res(arrs["parent_pos"], arrs["parent_ts"])
    at_sl = _res(at_pos, at_ts)
    apos = arrs["anchor_pos"]
    anchor_psl = np.where(
        is_add & (apos >= 0), parent_sl[np.clip(apos, 0, n - 1)],
        np.int32(NULL << 1)).astype(np.int32)
    # first-array-row-wins duplicate flag (= the kernel's scatter-min
    # winner election, which pack's first-add-per-ts dict also matches)
    dup = np.zeros(n, np.int8)
    rows = np.nonzero(has_rank)[0]
    first_of_rank = np.full(n + 1, n, np.int64)
    if rows.size:
        # reversed so the SMALLEST row with each rank wins the store
        first_of_rank[rank[rows][::-1]] = rows[::-1]
        dup[rows] = (rows != first_of_rank[rank[rows]]).astype(np.int8)
    # winner frame, host-elected: slot k+1's canonical row (IPOS32 when
    # unused) — the kernel's scatter-min, done once at ingest
    IPOS32 = 2**31 - 1
    win_row = np.where(first_of_rank[:n] < n, first_of_rank[:n],
                       IPOS32).astype(np.int32)
    # second-hop index: the parent's canonical row (-1 = root-level or
    # unresolved — both read as a zeroed parent frame downstream, which
    # is exactly what fp[ROOT] / fp[NULL] held)
    p_slot = parent_sl >> 1
    p_found = (parent_sl & 1).astype(bool)
    real_parent = p_found & (p_slot >= 1) & (p_slot <= n)
    pr = first_of_rank[np.clip(p_slot - 1, 0, n)]
    parent_row = np.where(real_parent & (pr < n), pr, -1).astype(np.int32)
    out = {"parent_sl": parent_sl, "at_sl": at_sl,
           "anchor_psl": anchor_psl, "dup_row": dup,
           "win_row": win_row, "parent_row": parent_row}
    crowd = derive_crowding_hints(arrs, out)
    if crowd is not None:
        out.update(crowd)
    return out


SLOT_HINT_COLS = ("parent_sl", "at_sl", "anchor_psl", "dup_row",
                  "win_row", "parent_row")

# sibling-crowding pre-pass hints — slot-space
# columns (entry k describes slot k+1), derived + VERIFIED below;
# capacity-dependent like the slot hints, so re-pads recompute them
CROWD_HINT_COLS = ("crowd_slot", "crowd_cpos")


def derive_crowding_hints(arrs: dict, slot_hints: dict):
    """The verified sibling-crowding pre-pass (ROADMAP's
    "verified-predicate design", scoped to the vouched all-adds case):
    when the host can PROVE from the already-derived slot hints that
    every canonical add is valid and every anchor is causally older
    (anchor slot < own slot), the kernel's order forest is the
    elementwise ``where(sentinel, pslot, aslot)`` — zero NSA trips —
    and the crowded-sibling structure is computable here with one
    ``bincount``.  The emitted columns let merge._finish skip the
    scatter-add + gather + cumsum trio STATICALLY:

    - ``crowd_slot`` i8[N]: 1 iff slot k+1 is a crowded-parent child
      (its order parent has ≥ 2 children) — the kernel's ``crowded``.
    - ``crowd_cpos`` i32[N]: inclusive crowded-count prefix minus one
      over slots 1..N — the kernel's ``cpos`` (ROOT/NULL never crowd).

    Returns ``None`` whenever ANY condition fails to verify — deletes
    present, an unresolved/invalid row, a non-causal anchor — so a
    batch the host cannot vouch keeps the device-side counting leg
    (utils/chainaudit records which leg a trace runs).  This is
    verification, not trust: every property checked here is exactly
    the property the kernel's validity stages would derive, so the
    emitted columns equal the device-computed ones bit for bit (pinned
    across the sweep shapes by tests/test_merge_kernel.py and
    tests/test_opsaxis.py)."""
    kind = arrs["kind"]
    ts = arrs["ts"]
    n = int(kind.shape[0])
    if n == 0 or np.any(kind == KIND_DELETE) or \
            "depth" not in arrs or "paths" not in arrs:
        return None
    win_row = slot_hints["win_row"]
    used = win_row < n
    rows = win_row[used]
    crowd_slot = np.zeros(n, np.int8)
    if rows.size:
        pf = slot_hints["parent_sl"][rows]
        af = slot_hints["at_sl"][rows]
        psl, pfd = pf >> 1, (pf & 1).astype(bool)
        asl, afd = af >> 1, (af & 1).astype(bool)
        slots = (np.nonzero(used)[0] + 1).astype(np.int64)
        anchor_sent = arrs["anchor_ts"][rows] == 0
        # causal anchors: 0 NSA trips ⇔ every non-sentinel anchor
        # resolved to a strictly smaller slot
        if not np.all(anchor_sent | (afd & (asl >= 1) & (asl < slots))):
            return None
        if not (np.all(pfd) and np.all(ts[rows] > 0)):
            return None
        d = arrs["depth"][rows].astype(np.int64)
        paths = arrs["paths"]
        D = int(paths.shape[1])
        root_par = psl == 0
        par_row = np.where(root_par, 0,
                           win_row[np.clip(psl - 1, 0, n - 1)])
        if not np.all(root_par | (par_row < n)):
            return None
        pd = np.where(root_par, 0, arrs["depth"][par_row])
        if not np.all((d >= 1) & (d <= D) & (d == pd + 1)):
            return None
        # claimed prefix == parent's materialised path (the kernel's
        # exact-equality check, vectorized): parent materialised =
        # parent claimed with its own ts at depth-1
        if D > 1 or np.any(d > 1):
            cols = np.arange(D, dtype=np.int64)[None, :]
            pp = np.where(root_par[:, None], 0, paths[par_row])
            pts = np.where(root_par, 0, ts[par_row])
            par_mat = np.where(cols == (pd - 1)[:, None],
                               pts[:, None], pp)
            if not np.all(np.where(cols < (d - 1)[:, None],
                                   paths[rows] == par_mat, True)):
                return None
        # anchor is a sibling: the anchor row's own parent resolution
        # must equal ours (the kernel's elementwise ``ansl`` check)
        a_par = slot_hints["anchor_psl"][rows] >> 1
        if not np.all(anchor_sent |
                      (afd & (a_par == psl) & (asl != 0))):
            return None
        # every canonical add verified valid: the order forest is
        # elementwise and crowding is one bincount
        star = np.where(anchor_sent, psl, asl).astype(np.int64)
        cnt = np.bincount(star, minlength=n + 2)
        crowd_slot[slots - 1] = (cnt[star] >= 2).astype(np.int8)
    crowd_cpos = (np.cumsum(crowd_slot, dtype=np.int64) - 1) \
        .astype(np.int32)
    return {"crowd_slot": crowd_slot, "crowd_cpos": crowd_cpos}


def verify_hints(p: PackedOps, check_rank: bool = True) -> bool:
    """Host-side audit that the hint columns carry exactly what the
    kernel's "exhaustive" mode assumes (ADVICE r3: a restore must not
    trust a persisted vouch over possibly stale/corrupt columns).

    True iff (a) ``ts_rank`` equals a fresh ``compute_ts_rank`` over the
    loaded kind/ts columns, (b) every nonzero in-batch-resolvable
    reference (parent for every real op, anchor for adds, target for
    deletes) carries a hint that verifies (points at an add row whose
    ``ts`` equals the referenced timestamp), and (c) every nonzero
    UNRESOLVABLE reference carries ``-1`` — no stray hints.  (a)+(b)
    are the properties the kernel's auto mode re-derives on device
    (ops/merge.py rank/link verification); (c) is what the exhaustive
    mode's check-free resolution additionally trusts (it resolves
    ``hint >= 0`` without the per-hint ts gather,
    merge._res_hint_impl ``check_ts=False``).  When all three hold,
    exhaustive and auto are semantically identical, so a batch passing
    this check may keep the cond-free path.

    ``check_rank=False`` skips (a) — for callers whose PackedOps was
    built WITHOUT a ts_rank column (``__post_init__`` computed it from
    the same kind/ts the check would recompute from, so the comparison
    is tautologically true); persisted/foreign ts_rank columns (restore)
    must keep the default."""
    if check_rank and not np.array_equal(p.ts_rank,
                                         compute_ts_rank(p.kind, p.ts)):
        return False
    n = p.capacity
    is_add = p.kind == KIND_ADD
    uniq = np.unique(p.ts[is_add & (p.ts > 0)])

    def _refs_ok(active, want, hint):
        nonzero = active & (want > 0) & (want < MAX_TS)
        h = np.clip(hint, 0, n - 1)
        verified = (hint >= 0) & (hint < n) & is_add[h] & (p.ts[h] == want)
        if uniq.size:
            # membership by binary search — uniq is sorted; np.isin's
            # sort-based path re-sorted both sides per call
            i = np.minimum(np.searchsorted(uniq, want), uniq.size - 1)
            in_batch = uniq[i] == want
        else:
            in_batch = np.zeros(want.shape, bool)
        # resolvable refs must verify, AND unresolvable refs must carry
        # -1 (no stray hints): every producer emits -1 on lookup miss,
        # and the kernel's exhaustive mode relies on it — it resolves
        # ``hint >= 0`` WITHOUT the per-hint ts check gather
        # (merge._res_hint_impl check_ts=False), so a stray hint there
        # would silently mis-resolve instead of landing NOT_FOUND
        return bool(np.all(np.where(nonzero & in_batch, verified,
                                    ~nonzero | in_batch | (hint < 0))))

    return (_refs_ok(p.kind != KIND_PAD, p.parent_ts, p.parent_pos)
            and _refs_ok(is_add, p.anchor_ts, p.anchor_pos)
            and _refs_ok(p.kind == KIND_DELETE, p.ts, p.target_pos))


def pad_arrays(ops: dict, n: int) -> dict:
    """Pad a column dict's op axis to length ``n`` (pad rows are
    KIND_PAD; hint columns -1; ``pos`` continues its arange).

    Derived SLOT-hint columns encode NULL = capacity+1, so a capacity
    change invalidates them; they are recomputed from the padded base
    columns rather than padded (a stale NULL would alias a real slot
    of the wider frame)."""
    cur = ops["kind"].shape[0]
    if cur == n:
        return dict(ops)
    if cur > n:
        raise ValueError(f"op count {cur} exceeds target {n}")
    had_slot_hints = any(k in ops for k in SLOT_HINT_COLS)
    out = {}
    for k, v in ops.items():
        if k in SLOT_HINT_COLS or k in CROWD_HINT_COLS:
            continue
        pad_width = [(0, n - cur)] + [(0, 0)] * (v.ndim - 1)
        if k == "kind":
            out[k] = np.pad(v, pad_width, constant_values=KIND_PAD)
        elif k in ("value_ref", "parent_pos", "anchor_pos", "target_pos",
                   "ts_rank"):
            out[k] = np.pad(v, pad_width, constant_values=-1)
        elif k == "pos":
            out[k] = np.concatenate(
                [v, np.arange(cur, n, dtype=v.dtype)])
        else:
            out[k] = np.pad(v, pad_width)
    if had_slot_hints:
        out.update(derive_slot_hints(out))
    return out


def rebuild_hints(p: PackedOps) -> None:
    """Recompute the rank and link hint columns from kind/ts in place.

    The repair path for a failed restore audit (``verify_hints``):
    leaving corrupt hints in the object would push every later merge of
    the tree through the kernel's sort+join fallback for its lifetime,
    when the hints are one vectorized host pass to rebuild.  After this
    the columns are exhaustive and consistent with the data columns by
    construction, so the vouch is re-established."""
    p.ts_rank = compute_ts_rank(p.kind, p.ts)
    # positive timestamps only, so a zero or negative ref misses
    idx = TsIndex.of_adds(
        p.ts, np.nonzero((p.kind == KIND_ADD) & (p.ts > 0))[0])

    def _lookup(want, active):
        return np.where(active & (want < MAX_TS), idx.lookup(want),
                        -1).astype(np.int32)

    p.parent_pos = _lookup(p.parent_ts, p.kind != KIND_PAD)
    p.anchor_pos = _lookup(p.anchor_ts, p.kind == KIND_ADD)
    p.target_pos = _lookup(p.ts, p.kind == KIND_DELETE)
    p.ts_index = None
    p.slot_hints = None
    p.hints_vouched = True


def _bucket(n: int, minimum: int = 8) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def _depth_bucket(d: int, cap: int) -> int:
    """Smallest power-of-two path width ≥ ``d`` (min 1), clipped to the
    caller's ``max_depth`` cap."""
    w = 1
    while w < d:
        w *= 2
    return min(w, cap) if d <= cap else w


def pack(ops, max_depth: int = DEFAULT_MAX_DEPTH,
         capacity: Optional[int] = None) -> PackedOps:
    """Flatten an operation (or iterable of operations) into packed arrays.

    Batches are flattened depth-first; ``pos`` records the resulting
    sequential order.  Out-of-range input raises rather than truncating:
    paths longer than ``max_depth`` (re-pack deeper) and timestamps or path
    elements outside ``[0, MAX_TS)`` (the kernel's sentinel space).

    The stored path width is the power-of-two bucket of the batch's
    actual deepest path, NOT ``max_depth`` (which is only the cap): a
    flat editor log packs as ``paths[N, 1]`` instead of dragging a
    ``[N, 16]`` int64 plane through every kernel gather/compare (v5e has
    no native int64 — the wide plane was measured as a top-3 cost at the
    1M-op headline).  The kernel re-specialises per (capacity, depth)
    bucket; the persistent compilation cache (utils/compcache) absorbs
    the extra variants.
    """
    if isinstance(ops, (Add, Delete, Batch)):
        ops = [ops]
    flat: List[Operation] = []
    for op in ops:
        flat.extend(op_mod.iter_leaves(op))

    n = len(flat)
    cap = capacity if capacity is not None else _bucket(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < op count {n}")

    deepest = max((len(op.path) for op in flat), default=1)
    if deepest > max_depth:
        raise ValueError(
            f"path depth {deepest} exceeds max_depth {max_depth}; "
            f"re-pack with a larger max_depth")
    width = _depth_bucket(deepest, max_depth)

    kind = np.full(cap, KIND_PAD, dtype=np.int8)
    ts = np.zeros(cap, dtype=np.int64)
    parent_ts = np.zeros(cap, dtype=np.int64)
    anchor_ts = np.zeros(cap, dtype=np.int64)
    depth = np.zeros(cap, dtype=np.int32)
    paths = np.zeros((cap, width), dtype=np.int64)
    value_ref = np.full(cap, -1, dtype=np.int32)
    pos = np.arange(cap, dtype=np.int32)
    values: List[Any] = []

    for i, op in enumerate(flat):
        path = op.path
        d = len(path)
        if any(e < 0 or e >= MAX_TS for e in path) or \
                (isinstance(op, Add) and not 0 <= op.ts < MAX_TS):
            raise ValueError(
                f"timestamp outside [0, 2**62) in {op!r}; replica ids must "
                f"be < 2**30")
        paths[i, :d] = path
        depth[i] = d
        if isinstance(op, Add):
            kind[i] = KIND_ADD
            ts[i] = op.ts
            anchor_ts[i] = path[-1] if path else 0
            parent_ts[i] = path[-2] if len(path) >= 2 else 0
            value_ref[i] = len(values)
            values.append(op.value)
        else:  # Delete
            kind[i] = KIND_DELETE
            ts[i] = path[-1] if path else 0
            anchor_ts[i] = path[-1] if path else 0
            parent_ts[i] = path[-2] if len(path) >= 2 else 0

    # link hints: resolve ts references to batch positions (first add wins,
    # matching the kernel's first-arrival dedup); -1 = not in this batch
    first: dict = {}
    for i, op in enumerate(flat):
        if isinstance(op, Add) and op.ts not in first:
            first[op.ts] = i
    parent_pos = np.full(cap, -1, dtype=np.int32)
    anchor_pos = np.full(cap, -1, dtype=np.int32)
    target_pos = np.full(cap, -1, dtype=np.int32)
    for i in range(n):
        if parent_ts[i]:
            parent_pos[i] = first.get(int(parent_ts[i]), -1)
        if kind[i] == KIND_ADD:
            if anchor_ts[i]:
                anchor_pos[i] = first.get(int(anchor_ts[i]), -1)
        elif ts[i]:
            target_pos[i] = first.get(int(ts[i]), -1)

    return PackedOps(kind=kind, ts=ts, parent_ts=parent_ts,
                     anchor_ts=anchor_ts, depth=depth, paths=paths,
                     value_ref=value_ref, pos=pos, values=values, num_ops=n,
                     parent_pos=parent_pos, anchor_pos=anchor_pos,
                     target_pos=target_pos,
                     ts_index=TsIndex.of_adds(ts, _add_rows(kind, n)),
                     hints_vouched=True)


def unpack(packed: PackedOps) -> List[Operation]:
    """Packed arrays → operation list (inverse of :func:`pack`)."""
    return unpack_rows(packed, 0, packed.num_ops)


def unpack_rows(packed: PackedOps, start: int, stop: int
                ) -> List[Operation]:
    """Operation objects for rows ``[start, stop)`` only — the columnar
    log (oplog.OpLog) materializes small suffixes through this without
    touching the rest.

    Columns convert once via ``.tolist()`` (C-speed, native ints) so the
    per-row work is only slicing and constructing the frozen op — at 1M
    rows the naive per-element numpy indexing was ~3x slower and sat on
    the serving ingest path (engine.apply_packed)."""
    start = max(start, 0)
    stop = min(stop, packed.num_ops)
    if stop <= start:
        return []
    kind = packed.kind[start:stop].tolist()
    ts = packed.ts[start:stop].tolist()
    depth = packed.depth[start:stop].tolist()
    paths = packed.paths[start:stop].tolist()
    vref = packed.value_ref[start:stop].tolist()
    values = packed.values
    out: List[Operation] = []
    append = out.append
    for i in range(stop - start):
        k = kind[i]
        path = tuple(paths[i][:depth[i]])
        if k == KIND_ADD:
            append(Add(ts[i], path, values[vref[i]]))
        elif k == KIND_DELETE:
            append(Delete(path))
    return out


def select_rows(p: PackedOps, idx: np.ndarray) -> PackedOps:
    """A new self-contained PackedOps holding rows ``idx`` of ``p`` (in
    that order): the columnar face of "keep only the APPLIED subset" on
    the partial-absorb ingest path (engine.apply_packed), where the old
    code unpacked the whole batch to filter objects.  Values are
    subset and renumbered; hints are rebuilt from the surviving rows
    (vectorized), so the result is vouched by construction."""
    idx = np.asarray(idx, dtype=np.int64)
    n = int(idx.size)
    cap = _bucket(n)
    depth = p.depth[idx] if n else np.zeros(0, np.int32)
    width = _depth_bucket(int(depth.max()) if n else 1, p.max_depth)

    vr = p.value_ref[idx]
    has_val = vr >= 0
    values = [p.values[j] for j in vr[has_val].tolist()]
    new_vref = np.full(cap, -1, dtype=np.int32)
    new_vref[:n][has_val] = np.arange(len(values), dtype=np.int32)

    out = PackedOps(
        kind=np.full(cap, KIND_PAD, dtype=np.int8),
        ts=np.zeros(cap, dtype=np.int64),
        parent_ts=np.zeros(cap, dtype=np.int64),
        anchor_ts=np.zeros(cap, dtype=np.int64),
        depth=np.zeros(cap, dtype=np.int32),
        paths=np.zeros((cap, width), dtype=np.int64),
        value_ref=new_vref,
        pos=np.arange(cap, dtype=np.int32),
        values=values, num_ops=n)
    out.kind[:n] = p.kind[idx]
    out.ts[:n] = p.ts[idx]
    out.parent_ts[:n] = p.parent_ts[idx]
    out.anchor_ts[:n] = p.anchor_ts[idx]
    out.depth[:n] = depth
    out.paths[:n] = p.paths[idx][:, :width]
    rebuild_hints(out)
    return out


def with_capacity(p: PackedOps, cap: int) -> PackedOps:
    """``p``'s rows re-padded to capacity ``cap`` (≥ ``num_ops``) in a
    new PackedOps; ``p`` is untouched.  Lets the serving scheduler align
    several documents' candidate sets to ONE shared capacity before a
    batched launch (parallel.mesh.stack_packed), so each document's
    parked table stays row-consistent with its own columns.  Value table,
    hint provenance, and the cached ts index carry over (the real rows —
    everything an index or hint can reference — are unchanged)."""
    if cap == p.capacity:
        return p
    if cap < p.num_ops:
        raise ValueError(f"capacity {cap} below op count {p.num_ops}")
    n = p.num_ops
    cols = pad_arrays({k: v[:n] for k, v in p.columns().items()}, cap)
    return PackedOps(
        kind=cols["kind"], ts=cols["ts"], parent_ts=cols["parent_ts"],
        anchor_ts=cols["anchor_ts"], depth=cols["depth"],
        paths=cols["paths"], value_ref=cols["value_ref"],
        pos=cols["pos"], values=p.values, num_ops=n,
        parent_pos=cols["parent_pos"], anchor_pos=cols["anchor_pos"],
        target_pos=cols["target_pos"], ts_rank=cols["ts_rank"],
        hints_vouched=p.hints_vouched, ts_index=p.ts_index)


def concat(a: PackedOps, b: PackedOps) -> PackedOps:
    """Concatenate two packed batches (the semilattice union before a
    merge) — the two-part case of :func:`concat_many`.

    ``a``'s rows precede ``b``'s, and the kernel's stable timestamp sort
    makes the EARLIEST ARRAY ROW the canonical copy of a duplicate — so
    first-arrival dedup keeps ``a``'s copies, matching sequential
    application order a-then-b.  Invariant relied on by the kernel:
    ``pos == array index`` (the ``pos`` column feeds status/absorption
    ordering, not dedup).  Differing path widths (depth buckets) widen
    to the larger.

    An empty side returns the other side UNCOPIED (the fresh-document
    bootstrap ingests a 1M-op batch through here; a full column copy
    plus index rebuild was ~2.5 s of the warm serving path).  Callers
    treat PackedOps as immutable either way.
    """
    return concat_many([a, b])


# each column's dtype, in :meth:`PackedOps.columns` order
COLUMN_DTYPES = {
    "kind": np.int8, "ts": np.int64, "parent_ts": np.int64,
    "anchor_ts": np.int64, "depth": np.int32, "paths": np.int64,
    "value_ref": np.int32, "pos": np.int32, "parent_pos": np.int32,
    "anchor_pos": np.int32, "target_pos": np.int32, "ts_rank": np.int32,
}


def union_shape(parts: Sequence[PackedOps]) -> Tuple[int, int]:
    """The capacity and path width of ``concat_many(parts)``: the bucket
    of the parts' rows and the widest part's width; a lone part with
    rows keeps its own (it is returned uncopied), and no rows at all
    give ``pack([])``'s."""
    live = [p for p in parts if p.num_ops]
    if len(live) == 1:
        return live[0].capacity, live[0].max_depth
    if not live:
        return _bucket(0), 1
    return (_bucket(sum(p.num_ops for p in live)),
            max(p.max_depth for p in live))


def frame(docs: int, n: int, width: int) -> dict:
    """An unfilled column frame for ``docs`` documents: each column
    ``[docs, n]``, ``paths`` ``[docs, n, width]``.  Row ``i``
    (``{k: v[i] for k, v in frame.items()}``) is the ``out`` of one
    :func:`concat_many`, which writes every byte of it."""
    return {k: np.empty((docs, n, width) if k == "paths" else (docs, n),
                        dtype=dt) for k, dt in COLUMN_DTYPES.items()}


def concat_many(parts: Sequence[PackedOps],
                out: Optional[dict] = None) -> PackedOps:
    """Union of several packed batches in ONE allocation — the columnar
    log's full-state export (oplog.OpLog.to_packed), where a pairwise
    concat fold re-copied the growing prefix per segment (O(s·n) row
    copies for s segments).

    Row order is part order (first-arrival dedup matches sequential
    application).  Each part keeps its internal link hints (shifted);
    refs a part could not resolve internally are resolved by PROBING
    the per-part cached ``index()`` in part order, one vectorized
    ``lookup`` of all still-open refs per probed part — instead of
    materializing a merged all-timestamps index, and
    each part's index is built vectorized once and CACHED ON THE PART,
    so repeat exports of the same segments (checkpoint + snapshot +
    re-materialization) pay nothing the second time.  Typical
    anti-entropy (old log + new delta) leaves the old side's unresolved
    set empty, so the pass is O(new cross-references), not O(log).  A
    hint may point at any add row carrying the referenced timestamp —
    the kernel verifies ``ts[hint] == want`` and elects the canonical
    duplicate itself — so cross-part duplicate timestamps need no
    special casing; probing in part order keeps the deterministic
    first-part-wins choice anyway.  The union's ``ts_rank`` is merged
    from the parts' (:func:`_union_rank`), not sorted again; nothing
    new is cached on the parts, and the union has no ``ts_index``.

    ``out``, one row of a :func:`frame` (``paths`` ``[N, W]``), builds
    the union there instead of in fresh arrays: the live rows, then a
    pad tail as :func:`pad_arrays` fills it (``paths`` zero past each
    part's width).  The result's columns are views of the row, at
    capacity ``N`` and the union's own path width; a lone part is
    copied in too, keeping its cached ``ts_index``.  A row shorter or
    narrower than :func:`union_shape` raises ``ValueError`` before
    anything is written."""
    parts = [p for p in parts if p.num_ops]
    cap, width = union_shape(parts)
    if out is not None and (out["kind"].shape[0] < cap
                            or out["paths"].shape[1] < width):
        raise ValueError(
            f"a {out['kind'].shape[0]}-row, {out['paths'].shape[1]}-wide "
            f"frame row cannot hold a union of capacity {cap} and path "
            f"width {width}")
    if len(parts) <= 1:
        one = parts[0] if parts else pack([])
        return one if out is None else _copy_into(one, out)
    with profiling.span("packed.concat"):
        n = sum(p.num_ops for p in parts)
        values: List[Any] = []
        if out is None:
            u = PackedOps(
                kind=np.full(cap, KIND_PAD, dtype=np.int8),
                ts=np.zeros(cap, dtype=np.int64),
                parent_ts=np.zeros(cap, dtype=np.int64),
                anchor_ts=np.zeros(cap, dtype=np.int64),
                depth=np.zeros(cap, dtype=np.int32),
                paths=np.zeros((cap, width), dtype=np.int64),
                value_ref=np.full(cap, -1, dtype=np.int32),
                pos=np.arange(cap, dtype=np.int32),
                values=values, num_ops=n,
                ts_rank=np.full(cap, -1, dtype=np.int32))
        else:
            u = _row_ops(out, n, width, values)

        bases: List[int] = []
        b = 0
        for p in parts:
            bases.append(b)
            b += p.num_ops

        # refs no part resolved internally: (output column, global rows,
        # referenced timestamps)
        open_refs: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        for p, base in zip(parts, bases):
            k = p.num_ops
            for name in ("kind", "ts", "parent_ts", "anchor_ts", "depth",
                         "ts_rank"):
                getattr(u, name)[base:base + k] = getattr(p, name)[:k]
            u.paths[base:base + k, :p.max_depth] = p.paths[:k]
            u.paths[base:base + k, p.max_depth:] = 0
            shifted = p.value_ref[:k].copy()
            shifted[shifted >= 0] += len(values)
            u.value_ref[base:base + k] = shifted
            values.extend(p.values)

            for name, ref_col in (("parent_pos", "parent_ts"),
                                  ("anchor_pos", "anchor_ts"),
                                  ("target_pos", "ts")):
                h = getattr(p, name)[:k].copy()
                refs = getattr(p, ref_col)[:k]
                unresolved = h < 0
                h[~unresolved] += base
                if name == "target_pos":
                    unresolved &= p.kind[:k] == KIND_DELETE
                elif name == "anchor_pos":
                    unresolved &= p.kind[:k] == KIND_ADD
                todo = np.nonzero(unresolved & (refs != 0))[0]
                getattr(u, name)[base:base + k] = h
                if todo.size:
                    open_refs.append((getattr(u, name), todo + base,
                                      refs[todo]))

        n_open = sum(rows.size for _, rows, _ in open_refs)
        profiling.count("packed.index_lookups", n_open)
        if n_open:
            _resolve(open_refs, parts, bases)

        with profiling.span("packed.ts_rank"):
            _union_rank(u, bases)
        u.hints_vouched = all(p.hints_vouched for p in parts)
        return u


def _row_ops(out: dict, n: int, width: int, values: List[Any]
             ) -> PackedOps:
    """A PackedOps of views of the frame row ``out``, ``width`` of its
    path columns, whose rows past ``n`` are filled as
    :func:`pad_arrays` pads and whose path columns past ``width`` are
    zero; rows below ``n`` are the caller's to write (``pos`` is the
    arange throughout)."""
    tail = slice(n, None)
    out["kind"][tail] = KIND_PAD
    for name in ("ts", "parent_ts", "anchor_ts", "depth", "paths"):
        out[name][tail] = 0
    for name in ("value_ref", "parent_pos", "anchor_pos", "target_pos",
                 "ts_rank"):
        out[name][tail] = -1
    out["paths"][:n, width:] = 0
    out["pos"][:] = np.arange(out["pos"].shape[0], dtype=np.int32)
    return PackedOps(
        kind=out["kind"], ts=out["ts"], parent_ts=out["parent_ts"],
        anchor_ts=out["anchor_ts"], depth=out["depth"],
        paths=out["paths"][:, :width], value_ref=out["value_ref"],
        pos=out["pos"], values=values, num_ops=n,
        parent_pos=out["parent_pos"], anchor_pos=out["anchor_pos"],
        target_pos=out["target_pos"], ts_rank=out["ts_rank"])


def _copy_into(p: PackedOps, out: dict) -> PackedOps:
    """``p``'s rows in the frame row ``out``, padded to its length: what
    :func:`with_capacity` gives, in the row."""
    k = p.num_ops
    u = _row_ops(out, k, p.max_depth, p.values)
    for name in COLUMN_DTYPES:
        getattr(u, name)[:k] = getattr(p, name)[:k]
    u.hints_vouched, u.ts_index = p.hints_vouched, p.ts_index
    return u


def _resolve(open_refs, parts: Sequence[PackedOps], bases: List[int]
             ) -> None:
    """Write into each ``(column, rows, refs)`` of ``open_refs`` the
    global row of each ref's first add, probing the parts' indexes in
    part order (first part wins); refs no part holds get -1."""
    refs = np.concatenate([t for _, _, t in open_refs])
    got = np.full(refs.size, -1, dtype=np.int64)
    todo = np.arange(refs.size)
    for q, qb in zip(parts, bases):
        hit = q.index().lookup(refs[todo])
        found = hit >= 0
        got[todo[found]] = hit[found] + qb
        todo = todo[~found]
        if not todo.size:
            break
    ends = np.cumsum([rows.size for _, rows, _ in open_refs])
    for (col, rows, _), g in zip(open_refs, np.split(got, ends[:-1])):
        col[rows] = g


def write_packed_npz(path, p: PackedOps, meta: dict,
                     compress: bool = True) -> None:
    """Write the packed-checkpoint npz format: ``p``'s real rows plus a
    JSON ``meta`` sidecar — the reference's format, field for field.
    One format serves the checkpoint, the op log's cold segments, the
    WAL's records and the merge tier's requests; :func:`load_packed_npz`
    reads it back.  ``path`` may be a filesystem path or a binary
    file-like."""
    f = path if hasattr(path, "write") else open(path, "wb")
    n = p.num_ops
    try:
        (np.savez_compressed if compress else np.savez)(
            f, kind=p.kind[:n], ts=p.ts[:n],
            parent_ts=p.parent_ts[:n],
            anchor_ts=p.anchor_ts[:n], depth=p.depth[:n],
            paths=p.paths[:n], value_ref=p.value_ref[:n],
            pos=p.pos[:n], parent_pos=p.parent_pos[:n],
            anchor_pos=p.anchor_pos[:n], target_pos=p.target_pos[:n],
            ts_rank=p.ts_rank[:n],
            values=np.frombuffer(json.dumps(p.values).encode(), np.uint8),
            meta=np.frombuffer(json.dumps(meta).encode(), np.uint8))
    finally:
        if f is not path:
            f.close()


def load_packed_npz(path, light: bool = False):
    """Load one packed-ops npz (the :func:`write_packed_npz` wire/
    disk format) back into a :class:`PackedOps` — the segment-grade
    loader behind the tiered op log (oplog.py): cold segments and the
    checkpoint base round-trip through this, re-padded to the jit
    bucket, hint vouch re-verified on host (and REBUILT on mismatch,
    same policy as ``TpuTree.restore_packed``).

    Returns ``(p, meta)``; with ``light=True`` only the ``kind``/``ts``
    columns and the meta decode (the cheap open-time read the cascade
    uses to build its resident add-timestamp index without pulling a
    whole segment into memory) — then returns ``(cols_dict, meta)``.

    Every failure mode of a missing, truncated, corrupt, or
    hand-edited file — including the file not existing at all —
    raises a typed :class:`~crdt_graph_tpu_torch.core.errors.
    CheckpointError`: a spilled segment that cannot be read back MUST
    surface loudly (a silent partial log would serve wrong
    ``operations_since`` answers and wrong fingerprints forever)."""
    import struct
    import zipfile
    import zlib
    from ..core.errors import CheckpointError
    try:
        z = np.load(path)
        meta = json.loads(bytes(z["meta"]).decode())
        n = meta.get("num_ops")
        if not isinstance(n, int) or isinstance(n, bool) or \
                not (0 <= n <= int(z["kind"].shape[0])):
            raise ValueError(
                f"meta num_ops {n!r} inconsistent with column length "
                f"{int(z['kind'].shape[0])}")
        if light:
            return {"kind": z["kind"][:n], "ts": z["ts"][:n]}, meta
        cols = {k: z[k] for k in
                ("kind", "ts", "parent_ts", "anchor_ts", "depth",
                 "paths", "value_ref", "pos")}
        for k in ("parent_pos", "anchor_pos", "target_pos", "ts_rank"):
            if k in z.files:
                cols[k] = z[k]
        cols = pad_arrays(cols, _bucket(max(n, 1)))
        p = PackedOps(
            kind=cols["kind"], ts=cols["ts"],
            parent_ts=cols["parent_ts"], anchor_ts=cols["anchor_ts"],
            depth=cols["depth"], paths=cols["paths"],
            value_ref=cols["value_ref"], pos=cols["pos"],
            values=json.loads(bytes(z["values"]).decode()),
            num_ops=n,
            parent_pos=cols.get("parent_pos"),
            anchor_pos=cols.get("anchor_pos"),
            target_pos=cols.get("target_pos"),
            ts_rank=cols.get("ts_rank"),
            hints_vouched=bool(meta.get("hints_vouched", False)))
    except (OSError, zipfile.BadZipFile, zlib.error, KeyError,
            IndexError, ValueError, TypeError, AttributeError,
            NotImplementedError, EOFError, struct.error) as e:
        # OSError covers the MISSING-file case deliberately: unlike a
        # whole-tree restore (where a bad path is a caller bug), a
        # segment path comes from the log's own descriptors — its
        # absence means the spilled history was lost or collected out
        # from under us, which is exactly a corrupt-checkpoint condition
        raise CheckpointError(
            f"op-log segment {getattr(path, 'name', path)!r} unreadable: "
            f"{type(e).__name__}: {e}") from e
    # the vouch rides with the columns it vouches for (same hazard as
    # restore_packed): re-verify before honoring it, rebuild on failure
    if p.hints_vouched and not verify_hints(p):
        rebuild_hints(p)
    return p, meta


def verify_packed_npz(path, expect_ops: Optional[int] = None
                      ) -> Optional[str]:
    """CRC-verify one packed-npz tier file WITHOUT materializing its
    columns — the scrub pass's cheap integrity check (every npz member
    is a zip entry with a CRC-32; a flipped bit anywhere in member
    data fails it, a flip in the zip structure fails the open).
    Optionally cross-checks the meta row count against the
    descriptor's.  Returns None when healthy, else a short reason
    string (the scrub quarantines on ANY non-None answer — missing
    file included: lost history must never pass a scrub silently)."""
    import struct
    import zipfile
    import zlib
    try:
        with zipfile.ZipFile(path) as zf:
            bad = zf.testzip()
            if bad is not None:
                return f"crc mismatch in member {bad!r}"
        if expect_ops is not None:
            z = np.load(path)
            meta = json.loads(bytes(z["meta"]).decode())
            n = meta.get("num_ops")
            if n != expect_ops:
                return (f"meta num_ops {n!r} != descriptor "
                        f"{expect_ops}")
    except (OSError, zipfile.BadZipFile, zlib.error, KeyError,
            IndexError, ValueError, TypeError, EOFError,
            struct.error) as e:
        return f"{type(e).__name__}: {e}"
    return None


def pack_json(payload, max_depth: int = DEFAULT_MAX_DEPTH,
              capacity: Optional[int] = None) -> PackedOps:
    """Wire JSON (str/bytes) → :class:`PackedOps`, using the native parser
    when available (``crdt_graph_tpu_torch.native``), else the pure-Python
    path."""
    from .. import native
    if native.available():
        return native.parse_pack(payload, max_depth=max_depth,
                                 capacity=capacity)
    from . import json_codec
    if isinstance(payload, bytes):
        payload = payload.decode()
    return pack(json_codec.loads(payload), max_depth=max_depth,
                capacity=capacity)


# -- the anti-entropy egress ------------------------------------------------

EMPTY_BATCH_BYTES = b'{"op":"batch","ops":[]}'


def packed_since_bytes(p: PackedOps, initial_timestamp: int) -> bytes:
    """Anti-entropy wire JSON straight off packed columns: the suffix
    from the Add matching ``initial_timestamp`` (inclusive; 0 = full
    log; no match = empty batch), streamed through the native egress
    encoder (``native.encode_pack``), with the Python codec for a
    payload the native encoder refuses and when it is unavailable.  The
    applied log holds each add timestamp at most once, so the cached
    first-occurrence index IS the terminator."""
    from .. import native
    n = p.num_ops
    if initial_timestamp == 0:
        start = 0
    else:
        start = p.index().get(initial_timestamp)
        if start is None or start >= n:
            return EMPTY_BATCH_BYTES
    if native.available():
        try:
            return native.encode_pack(p, start)
        except ValueError:
            pass  # non-JSON-native payload: take the Python path
    return json_codec.dumps(op_mod.from_list(
        unpack_rows(p, start, n))).encode()


def window_bounds(log, since: int, limit: int):
    """The rows of a bounded, resumable anti-entropy window: ``(start,
    stop, None)`` for a window of rows ``[start, stop)``, or ``(0, 0,
    meta)`` when the answer is the empty batch (an unresolved mark, a
    caught-up log), ``meta`` being the window's meta for that case.
    ``limit`` ≤ 0 serves the unbounded suffix.  The reference's trimming
    rules:

    - a window ends on its last Add (the resume terminator; the
      trailing deletes re-serve next window), unless that Add is the
      inclusive terminator itself: a resumed window must make progress;
    - a window without such an Add extends through the next Add;
    - an all-delete log tail ships with its window (no later Add would
      carry it).

    ``log`` is one packing (``packed_since_window``) or an op log's
    view of its tiers (``oplog.LogView``): ``length``,
    ``index_of_add(ts)``, ``kinds(start, stop)``,
    ``next_add_at_or_after(pos)`` and ``last_add_pos``."""
    n = log.length
    if since == 0:
        start = 0
    else:
        start = log.index_of_add(since)
        if start is None or start >= n:
            return 0, 0, {"found": False, "more": False,
                          "next_since": None, "count": 0}
    if start >= n:
        return 0, 0, {"found": True, "more": False, "next_since": None,
                      "count": 0}
    stop = n
    if 0 < limit < n - start:
        window_adds = np.nonzero(
            log.kinds(start, start + limit) == KIND_ADD)[0]
        if len(window_adds) and (since == 0 or int(window_adds[-1]) > 0):
            stop = start + int(window_adds[-1]) + 1
        else:
            nxt = log.next_add_at_or_after(start + limit)
            stop = nxt + 1 if nxt is not None else n
        last = log.last_add_pos
        if stop < n and (last is None or last < stop):
            stop = n
    return start, stop, None


class _Rows:
    """One packing's real rows as the log :func:`window_bounds` reads."""

    def __init__(self, p: PackedOps):
        self.p = p
        self.length = p.num_ops

    def index_of_add(self, ts: int) -> Optional[int]:
        return self.p.index().get(ts)

    def kinds(self, start: int, stop: int) -> np.ndarray:
        return self.p.kind[start:stop]

    def next_add_at_or_after(self, pos: int) -> Optional[int]:
        later = np.nonzero(self.p.kind[pos:self.length] == KIND_ADD)[0]
        return pos + int(later[0]) if len(later) else None

    @property
    def last_add_pos(self) -> Optional[int]:
        adds = np.nonzero(self.p.kind[:self.length] == KIND_ADD)[0]
        return int(adds[-1]) if len(adds) else None


def packed_since_window(p: PackedOps, initial_timestamp: int,
                        limit: int = 0):
    """Bounded, resumable anti-entropy window over one packing:
    ``(wire_bytes, {"found", "more", "next_since", "count"})``, its rows
    those of :func:`window_bounds`."""
    start, stop, early = window_bounds(_Rows(p), initial_timestamp, limit)
    if early is not None:
        return EMPTY_BATCH_BYTES, early
    n = p.num_ops
    if stop >= n:
        body = packed_since_bytes(p, initial_timestamp)
    else:
        body = packed_since_bytes(select_rows(p, np.arange(start, stop)),
                                  0)
    served_adds = np.nonzero(p.kind[start:stop] == KIND_ADD)[0]
    next_since = int(p.ts[start + int(served_adds[-1])]) \
        if len(served_adds) else None
    return body, {"found": True, "more": stop < n,
                  "next_since": next_since, "count": stop - start}
