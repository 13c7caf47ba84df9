"""The batched semilattice join: N operations → converged node table.

The port of ``crdt_graph_tpu.ops.merge`` (the JAX reference), every hint
mode of it: the same packed columns give the same ``NodeTable``, field
for field and dtype for dtype; the reference's module docstring states
the algorithm (RGA order as the DFS pre-order of the min-ancestor
forest, Euler tour, run-contracted list ranking), and the stage numbers
in the comments below are its stages.

Hint modes, as in the reference: ``"exhaustive"`` trusts the producer's
hints (a vouched batch with the derived slot hints resolves every
reference elementwise); ``None``/``"auto"`` uses the rank and link hints
but verifies them on the device and falls back to the sort+join
construction when any is wrong (one counted predicate read, and one
count in :data:`fallbacks`); ``"join"`` ignores every hint.

What changes on the way from JAX to PyTorch:

- ``lax.while_loop`` / ``lax.cond`` become Python loops and branches on a
  predicate read back from the device; each read is counted in
  :data:`host_syncs`.  Every loop keeps the reference's trip cap and
  convergence test.
- JAX clamps out-of-range gather indices and drops out-of-range scatter
  targets; every index below is in range by construction or clamped
  explicitly, and every scatter drops its targets explicitly
  (``ops.indexing``).  Scatters whose indices may repeat are reductions
  (``amin``, ``index_add_``), exact under any write order.
- The v5e-only int64 bit splitting goes: Hopper has native int64, so the
  node-frame paths stay one i64 plane (split + repack is the identity).
- The 3-key sibling sort becomes one sort of a packed int64 key, and the
  stable 2-key ``(hi, lo)`` timestamp sort one stable sort of the int64
  timestamps themselves (the same order: the split is order-preserving).
- The four Pallas kernels of the path (the node-frame plane gathers, the
  tour prefix sums, the run expansion) are hand-written CUDA kernels on
  the card (``ops.fused_resolve``, ``ops.tour_scan``, ``ops.mono_gather``)
  and their plain PyTorch twins on the CPU.
- The reference's ops-axis partition context (``part``, from
  ``parallel.opsaxis``) threads through ``_resolve`` and ``_finish`` at
  the reference's hook sites; without it every path is unchanged.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..codec.packed import CROWD_HINT_COLS, KIND_ADD, KIND_DELETE, MAX_TS
from ..utils import chainaudit, hostenv, profiling
from . import fused_resolve, mono_gather, slot_hints, tour_scan
from .indexing import add_drop, min_drop, set_drop

# Per-op result statuses (sequential parity; see the reference docstring).
APPLIED = 0
ALREADY_APPLIED = 1   # duplicate add / repeat delete / edit under tombstone
NOT_FOUND = 2         # anchor or delete target missing from its branch
INVALID_PATH = 3      # empty path, missing intermediate, or prefix mismatch
PAD = 4

BIG = MAX_TS          # sorts-after-everything timestamp sentinel
IPOS = 2**31 - 1      # "no position" / +inf for int32 positions

S_CAP_DEFAULT = 1 << 16   # crowded-sibling sort width
R_CAP_DEFAULT = 1 << 15   # run-pipeline compact width
S_CAP2_DEFAULT = 1 << 12  # second (tiny) compact levels
R_CAP2_DEFAULT = 1 << 12

HINT_MODES = (None, "auto", "exhaustive", "join")
SLOT_HINTS = ("parent_sl", "at_sl", "anchor_psl", "dup_row")
LINK_HINTS = ("parent_pos", "anchor_pos", "target_pos")
# the columns every leg reads
BASE_COLS = ("kind", "ts", "parent_ts", "anchor_ts", "depth", "paths",
             "value_ref", "pos")
# the columns the slot-hinted exhaustive leg reads; the rest of a batch
# (the position hints, parent_ts) never leaves the host
MERGE_COLS = ("kind", "ts", "anchor_ts", "depth", "paths", "value_ref",
              "pos", "ts_rank") + SLOT_HINTS + (
                  "win_row", "parent_row", "crowd_slot", "crowd_cpos")

# Device→host reads of loop and branch predicates since the last reset:
# each is one stream synchronisation on the card.
host_syncs = 0
# Verified-hint merges whose verification failed and which took the
# sort+join construction instead, since the last reset.
fallbacks = 0


def _env_cap(name: str, default: int) -> int:
    """Compact-path width, overridable by the same environment names as
    the reference (``GRAFT_S_CAP``, ``GRAFT_R_CAP``, ``GRAFT_S_CAP2``,
    ``GRAFT_R_CAP2``), read at call time."""
    v = os.environ.get(name)
    return int(v) if v else default


def _read(x: torch.Tensor):
    """A 0-d predicate or count on the host (one counted sync)."""
    global host_syncs
    host_syncs += 1
    chainaudit.note_read()
    return x.item()


@dataclasses.dataclass
class NodeTable:
    """The converged tree as tensors over M = N + 2 slots (slot 0 the
    root, slots 1..N nodes, slot M-1 a null sink) — the reference's
    ``NodeTable`` with the same fields and dtypes."""

    ts: torch.Tensor           # i64[M] node timestamp (0 = root, BIG unused)
    parent: torch.Tensor       # i32[M] tree-parent slot (root: itself)
    depth: torch.Tensor        # i32[M]
    value_ref: torch.Tensor    # i32[M] host value-table index, -1 none
    paths: torch.Tensor        # i64[M, D] full materialised path
    exists: torch.Tensor       # bool[M] slot holds a real, valid node
    tombstone: torch.Tensor    # bool[M] node itself deleted
    dead: torch.Tensor         # bool[M] some strict ancestor deleted
    visible: torch.Tensor      # bool[M] exists & ~tombstone & ~dead
    doc_index: torch.Tensor    # i32[M] position in document order
    order: torch.Tensor        # i32[M] slots of existing nodes in order
    visible_order: torch.Tensor  # i32[M] slots of visible nodes in order
    num_nodes: torch.Tensor    # i32 count of existing nodes
    num_visible: torch.Tensor  # i32 count of visible nodes
    status: torch.Tensor       # i8[N] per-op status (batch order)

    @property
    def capacity(self) -> int:
        return int(self.ts.shape[0]) - 2

    @property
    def null_slot(self) -> int:
        return int(self.ts.shape[0]) - 1


FIELDS = tuple(f.name for f in dataclasses.fields(NodeTable))


def _ceil_log2(n: int) -> int:
    return max(1, math.ceil(math.log2(max(2, n))))


def _pack_u(h: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Two int32 halves → one int64 (the reference's ``_pack_u``)."""
    return (h.to(torch.int64) << 32) | (l.to(torch.int64) & 0xFFFFFFFF)


def _g(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` along the last axis, each document's indices into its own
    row (in range by construction)."""
    return torch.gather(x, -1, i.long())


def _read_all(x: torch.Tensor) -> bool:
    """Whether a per-document predicate holds for every document: one
    counted read (of the predicate itself for one document)."""
    return _read(x if x.numel() == 1 else torch.all(x))


def _read_max(x: torch.Tensor) -> int:
    """The largest of a per-document count: one counted read."""
    return _read(x if x.numel() == 1 else torch.max(x))


# -- the kernels, on one document or on a batch ------------------------------

def _plane_rows(plane, idx):
    """Kernel 1 (``[R, C]`` and ``[T]``) or its batched form (``[B, R,
    C]`` and ``[B, T]``): one launch either way."""
    if idx.dim() == 1:
        return fused_resolve.plane_rows(plane, idx)
    return fused_resolve.plane_rows_batched(plane, idx)


def _plane_rows2(plane, idx, hop_col: int):
    """Kernel 2, on one document or a batch (see :func:`_plane_rows`)."""
    if idx.dim() == 1:
        return fused_resolve.plane_rows2(plane, idx, hop_col)
    return fused_resolve.plane_rows2_batched(plane, idx, hop_col)


def _prefix_sums(boundary, weights):
    """Kernel 3, on one document or a batch."""
    if boundary.dim() == 1:
        return tour_scan.prefix_sums(boundary, weights)
    return tour_scan.prefix_sums_batched(boundary, weights)


def _monotone_gather(values, rid):
    """Kernel 4, on one document or a batch."""
    if rid.dim() == 1:
        return mono_gather.monotone_gather(values, rid)
    return mono_gather.monotone_gather_batched(values, rid)


def _fix_and(ok, ptr, cap: int):
    """AND of ``ok`` over every ancestor along ``ptr`` chains, by pointer
    doubling with early exit and a static trip cap (reference
    ``_fix_and``).  In a batch the loop runs until no document changes:
    a round on a document whose pointers are at their roots ANDs each
    node with its root's value again, which it already holds."""
    live, i = True, 0
    with chainaudit.loop():
        while live and i < cap and _read(torch.any(~ok)):
            ok = ok & _g(ok, ptr)
            ptr2 = _g(ptr, ptr)
            live = _read(torch.any(ptr2 != ptr))
            ptr, i = ptr2, i + 1
    return ok


def _fix_min(val, ptr, active: bool, cap: int):
    """MIN of ``val`` over self and every ancestor along ``ptr`` chains;
    skipped when ``active`` is false (reference ``_fix_min``).  Extra
    rounds on a converged document take the minimum with its roots'
    values again: no change."""
    live, i = active, 0
    with chainaudit.loop():
        while live and i < cap:
            val = torch.minimum(val, _g(val, ptr))
            ptr2 = _g(ptr, ptr)
            live = _read(torch.any(ptr2 != ptr))
            ptr, i = ptr2, i + 1
    return val


def _probe_sum(*arrs) -> int:
    """Stage-cut checksum (``probe=k``): the reference's fingerprint of
    the same arrays, as a Python int in int32 range."""
    from ..bench.honest import fingerprint, wrap_i32
    return wrap_i32(int(fingerprint(arrs)))


def _acc(acc: int, *arrs) -> int:
    """``acc`` plus the checksum of ``arrs``, wrapping like int32."""
    from ..bench.honest import wrap_i32
    return wrap_i32(acc + _probe_sum(*arrs))


def _sib_links(kp, gg, neg, M: int):
    """Sibling links from a sort by ``(kp, gg, neg)`` at the input width;
    rows with ``neg == IPOS`` are padding (slot maps to M, writes drop).

    The reference's 3-key ``lax.sort`` becomes ONE sort of a packed
    int64 key: real parents are below M ≤ 2^30 and padding keys clamp to
    M (still last), the group bit sits below, and the biased ``neg``
    fills the low 32 bits.  Rows with equal keys are identical, so the
    sort needs no stability."""
    lead = tuple(kp.shape[:-1])
    dev = kp.device
    kpc = torch.clamp(kp.to(torch.int64), max=M)
    key = (kpc << 33) | (gg.to(torch.int64) << 32) | \
        (neg.to(torch.int64) + 2**31)
    skey = torch.sort(key).values
    s_parent = skey >> 33
    s_neg = (skey & 0xFFFFFFFF) - 2**31
    s_slot = torch.where(s_neg == IPOS, M, -s_neg)
    same_parent = (s_parent[..., 1:] == s_parent[..., :-1]) & \
        (s_slot[..., 1:] < M)
    sib = set_drop(torch.full(lead + (M,), -1, dtype=torch.int32, device=dev),
                   s_slot[..., :-1],
                   torch.where(same_parent, s_slot[..., 1:], -1))
    s_start = torch.cat([torch.ones(lead + (1,), dtype=torch.bool,
                                    device=dev), ~same_parent], -1)
    fc_tgt = torch.where(s_start & (s_slot < M), s_parent, M)
    fc = set_drop(torch.full(lead + (M,), -1, dtype=torch.int32, device=dev),
                  fc_tgt, s_slot)
    return sib, fc


def _finish(ops: Dict[str, torch.Tensor], sel, no_deletes: bool,
            probe: Optional[int], acc: Optional[int], part=None):
    """Stages 3-13 from the resolution 10-tuple (reference ``_finish``,
    with every round-7 cut on).  A resolution that leaves ``node_ts`` and
    ``node_pos`` as None is the fused slot-hint leg: both come from the
    node-frame plane gather.  Otherwise (the ranked, link-hinted and
    sort+join legs) they are given, the plane carries no extras, the
    parent frame is a row gather through ``pslot`` and the anchor's
    parent a plain index.

    Every column is one document's ``[N]`` or a batch's ``[B, N]`` (the
    reference's body under ``vmap``): each op works along the last axis,
    each kernel launches once for the batch, and each host decision
    (:func:`_read`) is one read for the whole batch — a loop runs until
    no document changes, a tier fits the batch's largest document (a
    tier changes speed, never a table), sizes that differ by document
    pad to the batch's largest with a mask per document.

    ``part`` is the ops-axis partition context
    (``parallel.opsaxis.OpsAxisPart``, one document only) or None.
    Under it the merge's memory-bound ops go through the context's
    sharded forms at the reference's hook sites, and the node frame
    takes the one-hop plane (the reference's sharded trace runs without
    its device kernels, and the two-hop frame is device-only there); the
    table is the same."""
    kind = ops["kind"]
    dev = kind.device
    ts = ops["ts"].to(torch.int64)
    anchor_ts = ops["anchor_ts"].to(torch.int64)
    depth = ops["depth"].to(torch.int32)
    paths = ops["paths"].to(torch.int64)
    value_ref = ops["value_ref"].to(torch.int32)
    pos = ops["pos"].to(torch.int32)
    N = kind.shape[-1]
    lead = tuple(kind.shape[:-1])
    D = paths.shape[-1]
    M = N + 2
    ROOT = 0
    NULL = M - 1
    i32 = dict(dtype=torch.int32, device=dev)
    slot_ids = torch.arange(M, **i32)
    cols = torch.arange(D, **i32)[None, :]
    is_add = kind == KIND_ADD
    is_del = kind == KIND_DELETE
    (op_slot, op_is_dup, node_ts, node_pos, is_node_slot, node_row,
     pp_slot, at_slot, pp_found, at_found) = sel
    fused = node_ts is None
    chainaudit.stage(2)
    single_w = no_deletes

    # ---- 3. Node frame: every per-node field is the canonical source
    # row's op field, gathered through ``node_row`` in ONE plane sweep —
    # kernel 1, ``plane_rows``; on the fused leg with ``parent_row`` on
    # the plane the same sweep also fetches each node's parent row (the
    # second hop) — kernel 2, ``plane_rows2``.
    nsr = torch.where(is_node_slot, node_row, 0)
    dsv_src = _pack_u((depth << 1) | (anchor_ts == 0).to(torch.int32),
                      value_ref)
    pa = _pack_u((pp_slot << 1) | pp_found.to(torch.int32),
                 (at_slot << 1) | at_found.to(torch.int32))
    extra = []
    if fused:
        ap_src = _pack_u(ops["anchor_psl"].to(torch.int32), pos)
        extra = [ap_src[..., None], ts[..., None]]
    fused2 = fused and "parent_row" in ops and part is None
    rows = part.gather_rows if part is not None else _g
    if fused2:
        extra.append(ops["parent_row"].to(torch.int64)[..., None])
    HOP_COL = 2 + len(extra) - 1
    plane = torch.cat([dsv_src[..., None], pa[..., None]] + extra + [paths],
                      dim=-1).contiguous()
    nsr = nsr.to(torch.int32).contiguous()
    if fused2:
        g, g2 = _plane_rows2(plane, nsr, HOP_COL)
    elif part is not None:
        g, g2 = part.plane_rows(plane, nsr), None
    else:
        g, g2 = _plane_rows(plane, nsr), None
    k = 2 + len(extra)
    dsv, pa_g, claimed_raw = g[..., 0], g[..., 1], g[..., k:]
    if fused:
        ap_g, ts_g = g[..., 2], g[..., 3]
        node_ts = torch.where(is_node_slot, ts_g, BIG)
        node_ts[..., ROOT] = 0
        node_pos = torch.where(is_node_slot,
                               (ap_g & 0xFFFFFFFF).to(torch.int32), IPOS)
        ansl = torch.where(is_node_slot, (ap_g >> 32).to(torch.int32),
                           NULL << 1)
    node_depth = torch.where(is_node_slot, (dsv >> 33).to(torch.int32), 0)
    node_depth[..., ROOT] = 0
    node_anchor_is_sentinel = is_node_slot & (((dsv >> 32) & 1) != 0)
    node_value_ref = torch.where(is_node_slot,
                                 (dsv & 0xFFFFFFFF).to(torch.int32), -1)
    claimed = torch.where(is_node_slot[..., None], claimed_raw, 0)
    null2 = _pack_u(torch.tensor(NULL << 1, **i32),
                    torch.tensor(NULL << 1, **i32))
    pa_n = torch.where(is_node_slot, pa_g, null2)
    pf_pack = (pa_n >> 32).to(torch.int32)
    af_pack = (pa_n & 0xFFFFFFFF).to(torch.int32)
    pslot, pfound = pf_pack >> 1, (pf_pack & 1) != 0
    aslot, afound = af_pack >> 1, (af_pack & 1) != 0
    d_tslot, d_tfound = at_slot, at_found
    dp_slot, dp_found = pp_slot, pp_found
    pslot[..., ROOT] = ROOT

    # full materialised path: the claimed anchor path with the node's
    # own timestamp at depth-1
    col = torch.clamp(node_depth - 1, 0, D - 1)
    put = (cols == col[..., None]) & (node_depth[..., None] > 0)
    fp = torch.where(put, node_ts[..., None], claimed)

    # ---- 5. Local validity: claimed prefix == the parent's materialised
    # path, anchor a sibling, depths chain.
    if fused2:
        # parent frame from the second hop: the parent's claimed path
        # with its own timestamp at its depth-1 (zeroed when the parent
        # is the root, unresolved or absent)
        pvalid = is_node_slot & (g[..., HOP_COL] >= 0)
        par_depth = torch.where(pvalid, (g2[..., 0] >> 33).to(torch.int32),
                                0)
        pc = torch.where(pvalid[..., None], g2[..., k:], 0)
        pts = torch.where(pvalid, g2[..., 3], 0)
        put_p = (cols == torch.clamp(par_depth - 1, 0, D - 1)[..., None]) & \
            (par_depth[..., None] > 0)
        par = torch.where(put_p, pts[..., None], pc)
    else:
        # parent path + depth in one [M, D+1] row gather through pslot
        pplane_src = torch.cat([fp, node_depth[..., None].to(torch.int64)],
                               dim=-1).contiguous()
        pplane = part.plane_rows(pplane_src, pslot) if part is not None \
            else _plane_rows(pplane_src, pslot.contiguous())
        par, par_depth = pplane[..., :D], pplane[..., D].to(torch.int32)
    prefix_ok = torch.all(
        torch.where(cols < node_depth[..., None] - 1, claimed == par, True),
        dim=-1)
    depth_ok = (node_depth >= 1) & (node_depth <= D) & \
        (node_depth == par_depth + 1)
    parent_ok = pfound & depth_ok & prefix_ok
    anchor_parent = ansl >> 1 if fused else rows(pslot, aslot)
    anchor_ok = node_anchor_is_sentinel | \
        (afound & (anchor_parent == pslot) & (aslot != ROOT))
    local_ok = is_node_slot & (node_ts > 0) & parent_ok & anchor_ok
    local_ok[..., ROOT] = True
    if probe is not None:
        acc = _acc(acc, local_ok, parent_ok, fp)
        if probe == 2:
            return acc
    chainaudit.stage(3)

    # ---- 6. Validity cascades along the anchor forest; 6b. anchor
    # cycles (only when some anchor has a larger slot; in a batch, for
    # every document when any has one: a document without such an
    # anchor has no cycle, so the chase marks its every chain acyclic).
    order_parent = torch.where(node_anchor_is_sentinel, pslot, aslot)
    order_parent[..., ROOT] = ROOT
    order_parent[..., NULL] = NULL
    op_l = order_parent.long()
    cascade_ok = _fix_and(local_ok | ~is_node_slot, op_l,
                          _ceil_log2(M) + 1)
    up_edge = torch.any(is_node_slot & ~node_anchor_is_sentinel &
                        (aslot != NULL) & (aslot >= slot_ids))
    if _read(up_edge):
        p = op_l
        with chainaudit.loop():
            for _ in range(_ceil_log2(M) + 1):
                p = _g(p, p)
        acyclic = (p == ROOT) | (p == NULL)
    else:
        acyclic = torch.ones(lead + (M,), dtype=torch.bool, device=dev)
    valid = cascade_ok & acyclic & is_node_slot
    valid[..., ROOT] = True
    parent_eff = torch.where(valid, pslot, NULL).to(torch.int32)
    parent_eff[..., ROOT] = ROOT
    if probe is not None:
        acc = _acc(acc, valid, parent_eff)
        if probe == 3:
            return acc
    chainaudit.stage(4)

    # ---- 7. Deletes (statically absent under the no-deletes promise):
    # the target's materialised path, depth and validity arrive in one
    # row gather of an [M, D+1] plane — kernel 1, ``plane_rows``.
    if no_deletes:
        deleted = torch.zeros(lead + (M,), dtype=torch.bool, device=dev)
        anc_del = torch.full(lead + (M,), IPOS, **i32)
        dead = torch.zeros(lead + (M,), dtype=torch.bool, device=dev)
    else:
        tplane = torch.cat(
            [fp, ((node_depth.to(torch.int64) << 1) |
                  valid.to(torch.int64))[..., None]], dim=-1).contiguous()
        tg = part.gather_rows(tplane, d_tslot) if part is not None else \
            _plane_rows(tplane, d_tslot.contiguous())
        t_depth = (tg[..., D] >> 1).to(torch.int32)
        t_valid = (tg[..., D] & 1) != 0
        d_depth_ok = (depth >= 1) & (depth <= D) & (t_depth == depth)
        d_path_ok = torch.all(
            torch.where(cols < depth[..., None], paths == tg[..., :D], True),
            dim=-1)
        d_ok = is_del & d_tfound & (d_tslot != ROOT) & t_valid & \
            d_depth_ok & d_path_ok
        d_tgt = torch.where(d_ok, d_tslot, NULL)
        if part is not None:
            deleted = part.frame_reduce(
                M, 0, d_tgt, torch.ones(N, **i32), "max") != 0
            del_pos = part.frame_reduce(M, IPOS, d_tgt, pos, "min")
        else:
            deleted = set_drop(torch.zeros(lead + (M,), dtype=torch.bool,
                                           device=dev), d_tgt, True)
            del_pos = min_drop(torch.full(lead + (M,), IPOS, **i32), d_tgt,
                               pos)
        deleted[..., NULL] = False
        del_pos[..., NULL] = IPOS
        # ---- 8. Dead-subtree propagation down tree-parent chains
        pe = parent_eff.long()
        anc_del = torch.where(rows(deleted, parent_eff),
                              rows(del_pos, parent_eff), IPOS)
        anc_del = _fix_min(anc_del, pe, _read(torch.any(d_ok)),
                           _ceil_log2(D) + 1)
        dead = valid & (anc_del < IPOS)
    if probe is not None:
        acc = _acc(acc, deleted, dead, anc_del)
        if probe == 4:
            return acc
    chainaudit.stage(5)

    # ---- 9. The order forest: each node's T* parent is the nearest node
    # on its anchor chain with a smaller slot — pointer-halving chase,
    # finished by binary lifting for walkers the trip cap leaves behind.
    # A round moves only unresolved walkers: a resolved document's
    # pointers stay as they are.
    in_forest = valid & is_node_slot
    mptr0 = torch.where(node_anchor_is_sentinel | ~in_forest, -1, aslot)
    mptr = mptr0
    nsv_cap = _ceil_log2(M) + 2
    i = 0
    with chainaudit.loop():
        while i < nsv_cap and \
                _read(torch.any((mptr >= 0) & (mptr > slot_ids))):
            m = torch.where(mptr >= 0, mptr, NULL).long()
            unresolved = (mptr >= 0) & (mptr > slot_ids)
            mptr = torch.where(unresolved, _g(mptr, m), mptr)
            i += 1
    nsa_unresolved = (mptr >= 0) & (mptr > slot_ids)
    if probe == 41:
        return _acc(acc, mptr, nsa_unresolved)
    if _read(torch.any(nsa_unresolved)):
        up0 = torch.where(mptr0 >= 0, mptr0, ROOT).to(torch.int32)
        up0[..., ROOT] = ROOT
        ups, mns = [up0.long()], [up0]
        k_levels = _ceil_log2(M)
        cur = slot_ids.long().expand(lead + (M,))
        with chainaudit.loop():
            for _ in range(1, k_levels):
                pu, pm = ups[-1], mns[-1]
                ups.append(_g(pu, pu))
                mns.append(torch.minimum(pm, _g(pm, pu)))
            for kk in reversed(range(k_levels)):
                skip = nsa_unresolved & (_g(mns[kk], cur) >= slot_ids)
                cur = torch.where(skip, _g(ups[kk], cur), cur)
        ans = _g(up0, cur)
        lifted = torch.where(ans == ROOT, -1, ans)
        mptr = torch.where(nsa_unresolved, lifted, mptr)
    star_parent = torch.where(mptr >= 0, mptr, pslot)
    star_sentinel = mptr < 0
    if probe == 42:
        return _acc(acc, star_parent, star_sentinel)

    # Sibling sort → Euler-tour successor pointers: children of p are
    # child-branch T* roots (group 0), then same-branch T* children
    # (group 1), each group slot-DESCENDING.  Only crowded parents (≥ 2
    # children) need sorting, so they are compacted to a small width.
    order_parent = torch.where(in_forest, star_parent, order_parent)
    order_parent[..., ROOT] = ROOT
    order_parent[..., NULL] = NULL
    ggrp = torch.where(star_sentinel, 0, 1).to(torch.int8)
    skey = torch.where(in_forest, order_parent, NULL).to(torch.int32)
    neg_slot = torch.where(in_forest, -slot_ids, IPOS).to(torch.int32)
    S_CAP = _env_cap("GRAFT_S_CAP", S_CAP_DEFAULT)
    crowd_hinted = fused and _crowd_cols(ops, no_deletes)
    if S_CAP >= M:
        sib_next, first_child = _sib_links(skey, ggrp, neg_slot, M)
    else:
        # n_crowded_t: each document's crowded count, [..., 1]
        if crowd_hinted:
            pad_f = torch.zeros(lead + (1,), dtype=torch.bool, device=dev)
            crowded = torch.cat([pad_f, ops["crowd_slot"] != 0, pad_f], -1)
            cc = ops["crowd_cpos"].to(torch.int32)
            cpos = torch.cat([torch.full(lead + (1,), -1, **i32), cc,
                              cc[..., N - 1:N]], -1)
            n_crowded_t = cc[..., N - 1:N] + 1
        else:
            par = torch.where(in_forest, order_parent, M)
            cnt = part.frame_add(M, par) if part is not None else \
                add_drop(M, par)
            crowded = in_forest & (rows(cnt, torch.clamp(par, max=M - 1))
                                   >= 2)
            cpos = (part.cumsum(crowded) if part is not None else
                    torch.cumsum(crowded.to(torch.int32), -1,
                                 dtype=torch.int32)) - 1
            n_crowded_t = cpos[..., M - 1:M] + 1

        def fc_singletons(fc):
            """The singleton first-child overlay (every uncrowded
            parent's one child)."""
            single = in_forest & ~crowded
            tgt = torch.where(single, order_parent, M)
            val = torch.where(single, slot_ids, -1)
            if part is not None:
                ov = part.frame_set(M, -1, tgt, val, "max")
                return torch.where(ov >= 0, ov, fc)
            return set_drop(fc, tgt, val)

        def br_compact(cap):
            """The compact sibling branch at width ``cap`` ≥ the batch's
            largest crowded count: each document's k-th crowded row is
            the first index where its ``cpos`` reaches k (a binary
            search per compact slot); slots past its own count pad."""
            ks = torch.arange(cap, **i32).expand(lead + (cap,)).contiguous()
            src = torch.searchsorted(cpos, ks, right=False)
            valid_k = ks < n_crowded_t
            srcc = torch.clamp(src, max=M - 1)
            kp = torch.where(valid_k, _g(skey, srcc), IPOS)
            gg = torch.where(valid_k, _g(ggrp, srcc), 0).to(torch.int8)
            neg = torch.where(valid_k, _g(neg_slot, srcc), IPOS)
            sib, fc = _sib_links(kp, gg, neg, M)
            return sib, fc_singletons(fc)

        def br_single():
            """ALL crowded rows share one (parent, group) key, so their
            order is slot-descending: sib_next is the previous crowded
            slot (a running max), the key's first child the largest."""
            # running max of the crowded slots = the last crowded slot at
            # or before each row: the c-th crowded slot, c the count so
            # far (one cumsum and a scatter, not a cummax)
            if part is not None:
                pc = part.cummax(torch.where(crowded, slot_ids, -1))
            else:
                c = torch.cumsum(crowded.to(torch.int32), -1,
                                 dtype=torch.int32)
                c1 = c - 1
                kth = set_drop(torch.full(lead + (M,), -1, **i32),
                               torch.where(crowded, c1, M), slot_ids)
                pc = torch.where(c > 0, _g(kth, torch.clamp(c1, min=0)), -1)
            prev = torch.cat([torch.full(lead + (1,), -1, **i32),
                              pc[..., :-1]], -1)
            sib = torch.where(crowded, prev, -1).to(torch.int32)
            head = torch.amax(torch.where(crowded, slot_ids, -1), -1,
                              keepdim=True)
            gkey = torch.clamp(torch.amax(torch.where(crowded, skey, -1), -1,
                                          keepdim=True), 0, M - 1)
            fc = torch.full(lead + (M,), -1, **i32).scatter(
                -1, gkey.long(), head.to(torch.int32))
            return sib, fc_singletons(fc)

        # the single-group shortcut only when every document is one
        # group; else the smallest tier that fits the largest document
        gi = ggrp.to(torch.int32)
        one_group = (n_crowded_t > 0) & \
            (torch.amin(torch.where(crowded, skey, IPOS), -1, keepdim=True)
             == torch.amax(torch.where(crowded, skey, -1), -1,
                           keepdim=True)) & \
            (torch.amin(torch.where(crowded, gi, IPOS), -1, keepdim=True)
             == torch.amax(torch.where(crowded, gi, -1), -1, keepdim=True))
        S_CAP2 = _env_cap("GRAFT_S_CAP2", S_CAP2_DEFAULT)
        if _read_all(one_group):
            sib_next, first_child = br_single()
        else:
            n_crowded = _read_max(n_crowded_t)
            if S_CAP2 < S_CAP and n_crowded <= S_CAP2:
                sib_next, first_child = br_compact(S_CAP2)
            elif n_crowded <= S_CAP:
                sib_next, first_child = br_compact(S_CAP)
            else:
                sib_next, first_child = _sib_links(skey, ggrp, neg_slot, M)
    sib_next[..., ROOT] = -1
    first_child[..., NULL] = -1
    if probe == 43:
        return _acc(acc, sib_next, first_child)

    # ---- 10. Euler tour: enter(v) = token v, exit(v) = token M + v;
    # leaf exits are skipped (zero weight), parked tokens self-loop.
    T = 2 * M
    tok = torch.arange(T, **i32)
    in_tour = in_forest.clone()
    in_tour[..., ROOT] = True
    up = torch.where(order_parent == slot_ids, M + slot_ids,
                     M + order_parent)
    chain_next = torch.where(sib_next >= 0, sib_next, up)
    is_leaf = first_child < 0
    enter_succ = torch.where(~in_tour, slot_ids,
                             torch.where(is_leaf, chain_next, first_child))
    exit_succ = torch.where(~in_tour | is_leaf, M + slot_ids, chain_next)
    succ = torch.cat([enter_succ, exit_succ], -1).to(torch.int32)
    if probe is not None:
        acc = _acc(acc, succ, sib_next, first_child)
        if probe == 5:
            return acc
    chainaudit.stage(6)

    # ---- 11. Masks.
    exists = valid & is_node_slot
    tomb = deleted & exists
    dead = dead & exists
    visible = exists & ~tomb & ~dead

    # ---- 12. Document ranks by run contraction + weighted Wyllie.  The
    # run-id prefix sum and the weight lanes are kernel 3
    # (``prefix_sums``); the run→token expansion is kernel 4
    # (``monotone_gather``).
    fwd = succ[..., :-1] == tok[1:]
    bwd = succ[..., 1:] == tok[:-1]
    loop_ = succ == tok
    same_run = fwd | bwd | (loop_[..., :-1] & loop_[..., 1:])
    boundary = torch.cat([torch.ones(lead + (1,), dtype=torch.bool,
                                     device=dev), ~same_run], -1)
    w_lanes = torch.stack(
        [exists.to(torch.int32)] if single_w else
        [exists.to(torch.int32), visible.to(torch.int32)], -2).contiguous()
    scan = part.prefix_sums if part is not None else _prefix_sums
    rid_incl, w_incl = scan(boundary.to(torch.int32).contiguous(), w_lanes)
    rid = rid_incl - 1
    z1 = torch.zeros(lead + (1,), **i32)
    cse_doc = torch.cat([z1, w_incl[..., 0, :]], -1)
    cse_vis = cse_doc if single_w else torch.cat([z1, w_incl[..., 1, :]], -1)
    rid_m = rid[..., :M].contiguous()

    def runs_full():
        """T-wide run starts (each run has exactly one start token); a
        run ends where the next begins."""
        run_s = set_drop(torch.full(lead + (T,), IPOS, **i32),
                         torch.where(boundary, rid, T), tok)
        next_s = torch.cat([run_s[..., 1:],
                            torch.full(lead + (1,), IPOS, **i32)], -1)
        run_e = torch.where(run_s == IPOS, 0,
                            torch.where(next_s == IPOS, T - 1, next_s - 1))
        return run_s, run_e.to(torch.int32)

    def expand(run_s_w, run_e_w):
        """Per-run chain data at width w → Wyllie → the [4|7, M] token
        expansion (direction, weight-window bounds, suffix weights).  A
        padding run never lies on a real run's chain, so it changes no
        real run's sums; a round on a converged chain adds its
        terminal's zero."""
        w = run_s_w.shape[-1]
        run_s_l = run_s_w.long()
        run_fwd = _g(succ, torch.clamp(run_s_l, max=T - 1)) == run_s_l + 1
        run_tail = torch.where(run_fwd, run_e_w, run_s_w).long()
        tail_succ = _g(succ, torch.clamp(run_tail, max=T - 1)).long()
        run_terminal = tail_succ == run_tail
        rid_of = lambda x: _g(rid, torch.clamp(x, max=T - 1))  # noqa: E731
        run_next = torch.where(run_terminal, rid_of(run_tail),
                               rid_of(tail_succ))
        run_s_c = torch.clamp(run_s_l, max=M)
        run_e1_c = torch.clamp(run_e_w.long() + 1, max=M)
        a = torch.where(run_terminal, 0,
                        _g(cse_doc, run_e1_c) - _g(cse_doc, run_s_c))
        b = None if single_w else torch.where(
            run_terminal, 0, _g(cse_vis, run_e1_c) - _g(cse_vis, run_s_c))
        p = torch.clamp(run_next, max=w - 1).long()
        live, it, cap = True, 0, _ceil_log2(w) + 1
        with chainaudit.loop():
            while live and it < cap:
                a = a + _g(a, p)
                if b is not None:
                    b = b + _g(b, p)
                p2 = _g(p, p)
                live = _read(torch.any(p2 != p))
                p, it = p2, it + 1
        out = min(w, M)
        per_run = torch.stack([
            run_fwd[..., :out].to(torch.int32),
            _g(cse_doc, run_s_c[..., :out]), _g(cse_doc, run_e1_c[..., :out]),
            a[..., :out],
        ] + ([] if single_w else [
            _g(cse_vis, run_s_c[..., :out]), _g(cse_vis, run_e1_c[..., :out]),
            b[..., :out],
        ]), -2).to(torch.int32).contiguous()
        if part is not None:
            return part.mono_expand(per_run, rid_m)
        return _monotone_gather(per_run, rid_m)

    R_CAP = _env_cap("GRAFT_R_CAP", R_CAP_DEFAULT)
    if R_CAP >= T:
        ex = expand(*runs_full())
    else:
        # each document's last run id, [..., 1]; the tier fits the
        # batch's largest run count
        last_rid = rid[..., T - 1:T]
        n_runs = _read_max(last_rid) + 1

        def compact(cap):
            """The run pipeline at width ``cap`` ≥ n_runs: run k's first
            token is a binary search over the nondecreasing ``rid``; a
            document's runs past its own count pad."""
            ks = torch.arange(cap, **i32).expand(lead + (cap,)).contiguous()
            ss = torch.searchsorted(rid, ks, right=False)
            run_s_w = torch.where(ks <= last_rid, ss, IPOS)
            next_s = torch.cat([run_s_w[..., 1:],
                                torch.full(lead + (1,), IPOS,
                                           dtype=run_s_w.dtype, device=dev)],
                               -1)
            run_e_w = torch.where(run_s_w == IPOS, 0,
                                  torch.where(next_s == IPOS, T - 1,
                                              next_s - 1))
            return expand(run_s_w.to(torch.int32), run_e_w.to(torch.int32))

        R_CAP2 = _env_cap("GRAFT_R_CAP2", R_CAP2_DEFAULT)
        if R_CAP2 < R_CAP and n_runs <= R_CAP2:
            ex = compact(R_CAP2)
        elif n_runs <= R_CAP:
            ex = compact(R_CAP)
        else:
            ex = expand(*runs_full())
    if probe is not None:
        acc = _acc(acc, ex)
        if probe == 6:
            return acc
    chainaudit.stage(7)

    # E(tok) = weight at-or-after tok along the chain; ranks read at
    # ENTER tokens (0..M-1).
    rf_m = ex[..., 0, :] != 0

    def rank_of(ws_m, we1_m, a_m, cse):
        within = torch.where(rf_m, cse[..., :M] - ws_m,
                             we1_m - cse[..., 1:M + 1])
        e_tok = a_m - within
        return e_tok[..., ROOT:ROOT + 1] - e_tok

    def order_frame(mask, dense):
        """Rank→slot frame scatter (ranks are unique per mask)."""
        tgt = torch.where(mask, dense, M)
        if part is not None:
            return part.frame_set(M, NULL, tgt, slot_ids, "min")
        return set_drop(torch.full(lead + (M,), NULL, **i32), tgt, slot_ids)

    doc_dense = rank_of(ex[..., 1, :], ex[..., 2, :], ex[..., 3, :], cse_doc)
    doc_index = torch.where(exists, doc_dense, IPOS).to(torch.int32)
    order = order_frame(exists, doc_dense)
    if single_w:
        visible_order = order          # no deletes: visible ≡ exists
    else:
        vis_dense = rank_of(ex[..., 4, :], ex[..., 5, :], ex[..., 6, :],
                            cse_vis)
        visible_order = order_frame(visible, vis_dense)
    if probe is not None:
        acc = _acc(acc, doc_index, order, visible_order)
        if probe == 7:
            return acc

    # ---- 13. Sequential-parity statuses per op.
    status = torch.full(lead + (N,), PAD, dtype=torch.int8, device=dev)
    a_slot = op_slot.long()
    a_sentinel = ts <= 0
    if no_deletes:
        meta_s = valid.to(torch.int32) | (parent_ok.to(torch.int32) << 1)
        a_meta = rows(meta_s, op_slot)
        a_valid = (a_meta & 1) != 0
        a_parent_ok = (a_meta & 2) != 0
        # valid[pslot] (the NOT_FOUND/INVALID_PATH split) is read only
        # when some non-sentinel add is invalid
        if _read(torch.any(is_add & ~a_sentinel & ~a_valid)):
            a_grand = _g(_g(valid, pslot), a_slot)
            invalid = torch.where(a_parent_ok & a_grand, NOT_FOUND,
                                  INVALID_PATH)
        else:
            invalid = INVALID_PATH       # never selected
        a_status = torch.where(
            a_sentinel | (a_valid & op_is_dup), ALREADY_APPLIED,
            torch.where(a_valid, APPLIED, invalid))
        status = torch.where(is_add, a_status.to(torch.int8), status)
    else:
        meta = (valid.to(torch.int32)
                | (parent_ok.to(torch.int32) << 1)
                | (rows(valid, pslot).to(torch.int32) << 2))
        a_meta = rows(meta, op_slot)
        a_valid = (a_meta & 1) != 0
        a_parent_ok = (a_meta & 2) != 0
        a_grandvalid = (a_meta & 4) != 0
        a_absorbed = a_valid & (rows(anc_del, op_slot) < pos)
        a_status = torch.where(
            a_sentinel | (a_valid & (op_is_dup | a_absorbed)),
            ALREADY_APPLIED,
            torch.where(a_valid, APPLIED,
                        torch.where(a_parent_ok & a_grandvalid, NOT_FOUND,
                                    INVALID_PATH)))
        status = torch.where(is_add, a_status.to(torch.int8), status)
        d_parent_ok = (depth == 1) | \
            ((depth >= 2) & dp_found & ((rows(meta, dp_slot) & 1) != 0))
        d_anc_absorbed = d_ok & (rows(anc_del, d_tslot) < pos)
        d_repeat = d_ok & (rows(del_pos, d_tslot) < pos)
        d_target_later = d_ok & (rows(node_pos, d_tslot) > pos)
        d_sentinel = (ts == 0) & d_parent_ok
        d_status = torch.where(
            d_sentinel | d_anc_absorbed | (d_repeat & ~d_target_later),
            ALREADY_APPLIED,
            torch.where(d_ok & ~d_target_later, APPLIED,
                        torch.where(d_target_later | d_parent_ok,
                                    NOT_FOUND, INVALID_PATH)))
        status = torch.where(is_del, d_status.to(torch.int8), status)

    return NodeTable(
        ts=node_ts, parent=parent_eff, depth=node_depth,
        value_ref=node_value_ref, paths=fp, exists=exists, tombstone=tomb,
        dead=dead, visible=visible, doc_index=doc_index, order=order,
        visible_order=visible_order,
        num_nodes=torch.sum(exists, -1).to(torch.int32),
        num_visible=torch.sum(visible, -1).to(torch.int32),
        status=status)


def _node_cols_from_row(node_row, src_ts, src_pos, M: int, N: int):
    """Node-frame columns gathered through each slot's canonical source
    row (reference ``_node_cols_from_row``): unused slots read ts BIG and
    pos IPOS, the root ts 0."""
    is_node_slot = node_row < N
    wc = torch.where(is_node_slot, node_row, 0).long()
    node_ts = torch.where(is_node_slot, _g(src_ts, wc), BIG)
    node_ts[..., 0] = 0
    node_pos = torch.where(is_node_slot, _g(src_pos, wc), IPOS)
    return is_node_slot, node_ts, node_pos.to(torch.int32)


def _sorted_slots(is_add, ts, pos, N: int, M: int):
    """Sort-based slot assignment (reference ``_sorted_slots_impl``):
    the first six entries of the resolution tuple plus the sorted
    timestamp axis the join needs.

    The reference's stable sort of the ``(hi, lo)`` int32 halves is one
    stable sort of the int64 timestamps (the split preserves order;
    equal timestamps keep batch order, ``BIG`` sorts last).  Its
    ``cummax`` of run-start indices is the last run start so far: the
    c-th run start, c the running count of starts — a cumsum and one
    scatter, exactly."""
    dev = ts.device
    lead = tuple(ts.shape[:-1])
    i32 = dict(dtype=torch.int32, device=dev)
    NULL = M - 1
    sort_ts = torch.where(is_add & (ts > 0), ts, BIG)
    sorted_ts, sorted_idx = torch.sort(sort_ts, stable=True)
    sorted_idx = sorted_idx.to(torch.int32)
    run_start = torch.cat([torch.ones(lead + (1,), dtype=torch.bool,
                                      device=dev),
                           sorted_ts[..., 1:] != sorted_ts[..., :-1]], -1)
    not_big = sorted_ts < BIG
    is_canon = run_start & not_big
    c = torch.cumsum(run_start.to(torch.int32), -1, dtype=torch.int32)
    ar = torch.arange(N, **i32)
    starts = set_drop(torch.zeros(lead + (N,), **i32),
                      torch.where(run_start, c - 1, N), ar)
    slot_of_sorted = _g(starts, c - 1) + 1
    perm = sorted_idx.long()
    op_slot = torch.empty(lead + (N,), **i32)
    op_slot.scatter_(-1, perm, torch.where(not_big, slot_of_sorted,
                                           NULL).to(torch.int32))
    op_is_dup = torch.empty(lead + (N,), dtype=torch.bool, device=dev)
    op_is_dup.scatter_(-1, perm, ~run_start & not_big)
    node_row = set_drop(torch.full(lead + (M,), IPOS, **i32),
                        torch.where(is_canon, slot_of_sorted, M), sorted_idx)
    is_node_slot, node_ts, node_pos = _node_cols_from_row(
        node_row, sort_ts, pos, M, N)
    return (op_slot, op_is_dup, node_ts, node_pos, is_node_slot,
            node_row), sorted_ts


def _join_ops(sorted_ts, parent_ts, at_ts, N: int, M: int):
    """Per-op sort-merge join (reference ``_join_ops_impl``): the parent
    and the fused anchor-or-target references against the sorted add
    axis, by binary search."""
    queries = torch.cat([parent_ts, at_ts], -1)
    qidx = torch.searchsorted(sorted_ts, queries, side="left")
    qidx_c = torch.clamp(qidx, max=N - 1)
    qhit = (_g(sorted_ts, qidx_c) == queries) & (queries > 0) & \
        (queries < BIG)
    qslot = torch.where(queries == 0, 0,
                        torch.where(qhit, qidx_c + 1, M - 1)).to(torch.int32)
    qfound = (queries == 0) | qhit
    return qslot[..., :N], qslot[..., N:], qfound[..., :N], qfound[..., N:]


def _res_hint(hint, want, slot_or_neg, ts, N: int, M: int, check_ts: bool):
    """One link-hint resolution (reference ``_res_hint_impl``): the slot
    of the add row the hint points at, verified against the referenced
    timestamp when ``check_ts``; ``miss`` flags a nonzero reference
    without a verified hint."""
    p = torch.clamp(hint, 0, N - 1).long()
    sp = _g(slot_or_neg, p)
    ok = (hint >= 0) & (sp >= 0) & (want > 0) & (want < BIG)
    if check_ts:
        ok = ok & (_g(ts, p) == want)
    slot = torch.where(want == 0, 0, torch.where(ok, sp, M - 1))
    miss = (want > 0) & (want < BIG) & ~ok
    return slot.to(torch.int32), (want == 0) | ok, miss


def _resolve(ops: Dict[str, torch.Tensor], hints: Optional[str], leg: str,
             part=None):
    """Stages 1-2: slot assignment and timestamp→slot resolution, the
    leg chosen as the reference chooses it (merge.py ``_materialize``).

    - slot-hinted (``"exhaustive"`` with the derived slot hints): every
      reference resolves elementwise; node ts/pos come later from the
      fused plane gather (returned as None);
    - ranked (rank and link hints): slot = rank + 1, the winner frame a
      scatter-min, each link one gather; under ``None``/``"auto"`` the
      ranks and links are verified and a failure takes the sort+join;
    - link-hinted (link hints, no ranks): sorted slots, hinted links,
      the join only when some link misses;
    - hint-free (``"join"``, or no hint columns): sorted slots and the
      join.

    ``leg`` is :func:`select_leg` of the caller's columns.  Each
    verification is ONE predicate read back to the host; in a batch it
    holds for every document or the whole batch takes the sort+join
    (which gives a document with good hints its hinted resolution).
    Under the ops-axis context ``part`` the winner frame is its sharded
    scatter-min and the ranked leg's winner read-back its sharded
    gather."""
    global fallbacks
    kind = ops["kind"]
    dev = kind.device
    lead = tuple(kind.shape[:-1])
    ts = ops["ts"].to(torch.int64)
    pos = ops["pos"].to(torch.int32)
    N = kind.shape[-1]
    M = N + 2
    NULL = M - 1
    i32 = dict(dtype=torch.int32, device=dev)
    is_add = kind == KIND_ADD
    is_del = kind == KIND_DELETE
    def win_frame(has_rank, op_slot):
        """The winner scatter-min: the first array row per slot."""
        tgt = torch.where(has_rank, op_slot, M)
        row_idx = torch.arange(N, **i32)
        if part is not None:
            return part.frame_reduce(M, IPOS, tgt, row_idx, "min")
        return min_drop(torch.full(lead + (M,), IPOS, **i32), tgt, row_idx)

    if leg == "slot":
        rank = ops["ts_rank"].to(torch.int32)
        is_real_add = is_add & (ts > 0) & (ts < BIG)
        has_rank = is_real_add & (rank >= 0) & (rank < N)
        op_slot = torch.where(has_rank, rank + 1, NULL).to(torch.int32)
        if "win_row" in ops:
            pad = torch.full(lead + (1,), IPOS, **i32)
            win = torch.cat([pad, ops["win_row"].to(torch.int32), pad], -1)
        else:
            win = win_frame(has_rank, op_slot)
        op_is_dup = (ops["dup_row"] != 0) & has_rank
        pf = ops["parent_sl"].to(torch.int32)
        af = ops["at_sl"].to(torch.int32)
        return (op_slot, op_is_dup, None, None, win < N, win,
                pf >> 1, af >> 1, (pf & 1) != 0, (af & 1) != 0)

    parent_ts = ops["parent_ts"].to(torch.int64)
    anchor_ts = ops["anchor_ts"].to(torch.int64)
    at_ts = torch.where(is_add, anchor_ts, ts)

    def sorted_ops():
        slots, sorted_ts = _sorted_slots(is_add, ts, pos, N, M)
        return slots + _join_ops(sorted_ts, parent_ts, at_ts, N, M)

    def resolve_hinted(op_slot_arr):
        son = torch.where(is_add, op_slot_arr, -1).to(torch.int32)
        check = hints != "exhaustive"
        pp = _res_hint(ops["parent_pos"].to(torch.int32), parent_ts, son,
                       ts, N, M, check)
        at_hint = torch.where(is_add, ops["anchor_pos"].to(torch.int32),
                              ops["target_pos"].to(torch.int32))
        at = _res_hint(at_hint, at_ts, son, ts, N, M, check)
        return pp, at

    if leg == "rank":
        rank = ops["ts_rank"].to(torch.int32)
        is_real_add = is_add & (ts > 0) & (ts < BIG)
        has_rank = is_real_add & (rank >= 0) & (rank < N)
        op_slot = torch.where(has_rank, rank + 1, NULL).to(torch.int32)
        row_idx = torch.arange(N, **i32)
        # canonical copy = min array row per slot (first array row wins)
        win = win_frame(has_rank, op_slot)
        win_back = part.gather_rows(win, op_slot) if part is not None \
            else _g(win, op_slot)
        is_canon_op = has_rank & (row_idx == win_back)
        op_is_dup = has_rank & ~is_canon_op
        is_node_slot, node_ts, node_pos = _node_cols_from_row(
            win, ts, pos, M, N)
        ((pp_slot, pp_found, pp_miss),
         (at_slot, at_found, at_miss)) = resolve_hinted(op_slot)
        ranked = (op_slot, op_is_dup, node_ts, node_pos, is_node_slot, win,
                  pp_slot, at_slot, pp_found, at_found)
        if hints == "exhaustive":
            return ranked
        # the four rank properties hold iff ts_rank is exactly the
        # unique-add-timestamp rank; plus every link verified
        used = is_node_slot
        dense_ok = torch.all(~used[..., 2:M - 1] | used[..., 1:M - 2])
        incr_ok = torch.all(torch.where(
            used[..., 1:M - 1] & used[..., 2:M],
            node_ts[..., 1:M - 1] < node_ts[..., 2:M], True))
        ts_match = torch.all(torch.where(
            has_rank, _g(node_ts, torch.clamp(op_slot, 0, M - 1)) == ts,
            True))
        all_ranked = torch.all(~is_real_add | has_rank)
        link_miss = torch.any(pp_miss) | torch.any(at_miss & (is_add | is_del))
        hints_ok = dense_ok & incr_ok & ts_match & all_ranked & ~link_miss
        if _read(hints_ok):
            return ranked
        fallbacks += 1
        return sorted_ops()
    if leg == "link":
        slots, sorted_ts = _sorted_slots(is_add, ts, pos, N, M)
        ((pp_slot, pp_found, pp_miss),
         (at_slot, at_found, at_miss)) = resolve_hinted(slots[0])
        resolution = (pp_slot, at_slot, pp_found, at_found)
        if hints != "exhaustive":
            any_miss = torch.any(pp_miss) | \
                torch.any(at_miss & (is_add | is_del))
            if _read(any_miss):
                fallbacks += 1
                resolution = _join_ops(sorted_ts, parent_ts, at_ts, N, M)
        return slots + tuple(resolution)
    return sorted_ops()


def _crowd_cols(ops: Dict, no_deletes: bool) -> bool:
    """The slot-hinted leg's crowd columns replace the sibling count:
    no deletes, both columns present, ``GRAFT_CROWD_HINTS`` on."""
    return no_deletes and "crowd_slot" in ops and "crowd_cpos" in ops \
        and hostenv.flag_on("GRAFT_CROWD_HINTS")


def _compacted(n: int) -> bool:
    """Whether a merge of ``n`` rows sorts its crowded siblings on the
    compacted branch (``GRAFT_S_CAP`` below the slot count): the only
    branch with a sibling count for the crowd columns to replace."""
    return _env_cap("GRAFT_S_CAP", S_CAP_DEFAULT) < n + 2


def crowding_hinted(ops: Dict, hints: Optional[str],
                    no_deletes: bool) -> bool:
    """True when the merge of these columns takes the crowding leg that
    reads the host pre-pass columns (reference ``crowding_hinted``)."""
    return select_leg(ops, hints) == "slot" and \
        _compacted(ops["kind"].shape[-1]) and _crowd_cols(ops, no_deletes)


def select_leg(ops: Dict, hints: Optional[str]) -> str:
    """The resolution leg the reference's trace takes for these columns
    and this hint mode: ``"slot"``, ``"rank"``, ``"link"`` or ``"join"``
    (see :func:`_resolve`)."""
    if hints == "join" or not all(k in ops for k in LINK_HINTS):
        return "join"
    if "ts_rank" not in ops:
        return "link"
    if hints == "exhaustive" and all(k in ops for k in SLOT_HINTS):
        return "slot"
    return "rank"


# the columns each leg reads: the slot-hinted leg the 16 of MERGE_COLS,
# the others the base columns plus the position and rank hints they use
# — so each leg copies to the device only what it needs
LEG_COLS = {"slot": MERGE_COLS,
            "rank": BASE_COLS + LINK_HINTS + ("ts_rank",),
            "link": BASE_COLS + LINK_HINTS,
            "join": BASE_COLS}
# the columns a merge that derives its slot hints on the device copies:
# what the slot leg reads less the derived columns, plus what they are
# derived from (``ops.slot_hints.SOURCE_COLS``)
DERIVE_COLS = BASE_COLS + LINK_HINTS + ("ts_rank",)


def host_no_deletes(kind) -> bool:
    """The host-side check behind the no-deletes specialisation: True
    only for a host-resident kind column with no Delete row (for a
    batch's ``[B, N]`` column: in no document)."""
    if isinstance(kind, torch.Tensor):
        if kind.device.type != "cpu":
            return False
        kind = kind.numpy()
    return isinstance(kind, np.ndarray) and \
        not bool(np.any(kind == KIND_DELETE))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another.  With no card and no explicit device this raises —
    it never falls back to the CPU quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def materialize(ops: Dict, hints: Optional[str] = None, device=None,
                probe: Optional[int] = None, derive_hints: bool = False):
    """ops arrays (``codec.packed.PackedOps.arrays()``: numpy columns, or
    tensors) → :class:`NodeTable` on ``device`` (default: the card).

    ``hints`` is the reference's hint policy: ``None``/``"auto"`` use the
    hints and verify them, falling back to the sort+join construction
    when any is wrong (so wrong hints cost time, never correctness);
    ``"exhaustive"`` trusts a vouched producer's hints and never runs the
    sort or the join; ``"join"`` ignores hints.  ``probe=k`` (1-7, and
    the stage-5 sub-cuts 41-43) stops after stage k and returns the
    reference's cumulative checksum instead of a table.

    ``derive_hints=True`` (under ``"exhaustive"``, one document: the
    replica engine's vouched bulk merge) takes columns without the slot
    hints: the merge copies :data:`DERIVE_COLS`, derives the slot hints
    on the device (``ops.slot_hints``) and takes the slot leg, with the
    table ``arrays()``'s host-derived hints would give."""
    if hints not in HINT_MODES:
        raise ValueError(f"unknown hints mode {hints!r}; expected None, "
                         "'auto', 'exhaustive', or 'join'")
    if derive_hints and (hints != "exhaustive" or ops["kind"].ndim != 1
                         or not all(k in ops for k in DERIVE_COLS)):
        raise ValueError("derive_hints takes one document's vouched "
                         f"columns {DERIVE_COLS} under 'exhaustive'")
    return _materialize(ops, hints, resolve_device(device),
                        host_no_deletes(ops["kind"]), probe,
                        derive_hints=derive_hints)


@profiling.span("merge.materialize")
def _materialize(ops: Dict, hints: Optional[str], dev: torch.device,
                 no_deletes: bool, probe: Optional[int] = None, part=None,
                 derive_hints: bool = False):
    """The merge on ``dev`` with the no-deletes promise already checked
    (for a batch, in every document).  ``ops`` are one document's ``[N]``
    columns or a batch's ``[B, N]`` (``parallel.mesh``): a batch is ONE
    merge, one chain of dispatches and host reads, whose table carries
    the leading document axis.  ``part`` is the ops-axis partition
    context, which only ``parallel.opsaxis.materialize`` passes (one
    document).  ``derive_hints``: see :func:`materialize`."""
    from ..convert import ops_from_numpy
    leg = "slot" if derive_hints else select_leg(ops, hints)
    cols = DERIVE_COLS if derive_hints else LEG_COLS[leg]
    with profiling.span("merge.h2d"):
        t_ops = ops_from_numpy({k: ops[k] for k in cols if k in ops}, dev)
    if derive_hints:
        t_ops.update(_derive_slot_hints(t_ops, no_deletes))
    kind = t_ops["kind"]
    n = kind.shape[-1]
    if n + 2 > 2**30:
        raise ValueError("op count exceeds the 2^30 - 2 slot space")
    if part is not None and kind.dim() != 1:
        raise ValueError("the ops-axis merge takes one document")
    chainaudit.begin_merge(n, leg, not no_deletes,
                           docs=kind.shape[0] if kind.dim() == 2 else 1)
    try:
        sel = _resolve(t_ops, hints, leg, part)
        acc = _probe_sum(*(x for x in sel if x is not None)) \
            if probe is not None else None
        if probe == 1:
            return acc
        return _finish(t_ops, sel, no_deletes, probe, acc, part)
    finally:
        chainaudit.stage(0)


def _derive_slot_hints(t_ops: Dict[str, torch.Tensor],
                       no_deletes: bool) -> Dict[str, torch.Tensor]:
    """The slot-hint columns of one document's vouched columns, derived
    on their device (span ``packed.slot_hints``, count
    ``merge.slot_hints_on_card``).  The crowd columns are derived only
    where the merge would read them (no deletes, the compacted sibling
    branch, ``GRAFT_CROWD_HINTS`` on), and kept only where their
    verification holds: one counted read, and a refusal counted in
    ``merge.crowd_hints_refused``."""
    crowding = no_deletes and _compacted(t_ops["kind"].shape[-1]) and \
        hostenv.flag_on("GRAFT_CROWD_HINTS")
    with profiling.span("packed.slot_hints"), chainaudit.hints():
        cols, ok = slot_hints.derive(t_ops, crowding)
        profiling.count("merge.slot_hints_on_card")
        if ok is not None and not _read(ok):
            profiling.count("merge.crowd_hints_refused")
            for k in CROWD_HINT_COLS:
                del cols[k]
    return cols
