"""The slot-hint columns of a vouched batch, derived on its device.

``codec.packed.derive_slot_hints`` (ending in ``derive_crowding_hints``)
states in NumPy what the columns are; :func:`derive` computes the same
columns, dtype for dtype and value for value, from the batch's columns
already on the device.  So the engine's bulk merge copies the ten
columns the hints come from and not the eight derived ones
(``ops.merge.materialize(..., derive_hints=True)``), and the host pass
over the padded capacity leaves the step.  Plain torch: the same code
runs on CPU tensors and on the card, a few dozen elementwise ops,
gathers, one scatter-min, one histogram and one prefix sum, with no
read to the host.

Two places differ in form from the NumPy statement:

- NumPy elects the smallest row per rank with a reversed indexed store;
  here it is a scatter-min, since on the card an indexed store's
  duplicate writes land in any order.
- NumPy's crowding pre-pass returns None at its first failed check;
  here every check folds into one boolean tensor, ``ok``, which the
  caller reads once.  Where it is false the crowd columns must not be
  used (NumPy returns None there), whatever they hold.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..codec.packed import KIND_ADD, KIND_DELETE, MAX_TS
from .indexing import add_drop, min_drop

IPOS32 = 2**31 - 1   # win_row of an unused slot

# the columns :func:`derive` reads
SOURCE_COLS = ("kind", "ts", "parent_ts", "anchor_ts", "depth", "paths",
               "parent_pos", "anchor_pos", "target_pos", "ts_rank")


def derive(cols: Dict[str, torch.Tensor], crowding: bool
           ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor]]:
    """``(columns, ok)`` of one document's ``[N]`` columns (N >= 1, the
    padded capacity): ``parent_sl``, ``at_sl``, ``anchor_psl``,
    ``dup_row``, ``win_row`` and ``parent_row``, each equal to
    ``derive_slot_hints``'s; with ``crowding``, also ``crowd_slot`` and
    ``crowd_cpos`` and the 0-d bool ``ok``, true exactly where
    ``derive_crowding_hints`` verifies (and the two columns then equal
    its); without, ``ok`` is None."""
    kind, ts = cols["kind"], cols["ts"]
    rank = cols["ts_rank"].to(torch.int32)
    apos = cols["anchor_pos"].to(torch.int32)
    n = int(kind.shape[0])
    dev = kind.device
    ROOT, NULL = 0, n + 1
    is_add = kind == KIND_ADD
    has_rank = is_add & (ts > 0) & (ts < MAX_TS) & (rank >= 0) & (rank < n)
    son = torch.where(has_rank, rank + 1, NULL)
    son = torch.where(is_add, son, -1)

    def res(hint, want):
        """A reference's resolved slot << 1 | found."""
        sp = son.index_select(0, hint.clamp(0, n - 1))
        ok = (hint >= 0) & (sp >= 0) & (want > 0) & (want < MAX_TS)
        root = want == 0
        slot = torch.where(root, ROOT, torch.where(ok, sp, NULL))
        return (slot << 1) | (root | ok).to(torch.int32)

    parent_sl = res(cols["parent_pos"].to(torch.int32), cols["parent_ts"])
    at_sl = res(torch.where(is_add, apos, cols["target_pos"].to(torch.int32)),
                torch.where(is_add, cols["anchor_ts"], ts))
    anchor_psl = torch.where(is_add & (apos >= 0),
                             parent_sl.index_select(0, apos.clamp(0, n - 1)),
                             NULL << 1)
    # the smallest row of each rank (entry n, and every unused rank, n)
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    first = min_drop(torch.full((n + 1,), n, dtype=torch.int64, device=dev),
                     torch.where(has_rank, rank, n + 1), rows)
    dup_row = (has_rank & (first.index_select(0, rank.clamp(0, n)) != rows)
               ).to(torch.int8)
    head = first[:n]
    win_row = torch.where(head < n, head, IPOS32).to(torch.int32)
    p_slot = parent_sl >> 1
    real_parent = ((parent_sl & 1) != 0) & (p_slot >= 1) & (p_slot <= n)
    pr = first.index_select(0, (p_slot - 1).clamp(0, n))
    parent_row = torch.where(real_parent & (pr < n), pr, -1).to(torch.int32)
    out = {"parent_sl": parent_sl, "at_sl": at_sl, "anchor_psl": anchor_psl,
           "dup_row": dup_row, "win_row": win_row, "parent_row": parent_row}
    if not crowding:
        return out, None
    crowd, ok = _crowding(cols, out, n)
    out["crowd_slot"] = crowd.to(torch.int8)
    out["crowd_cpos"] = torch.cumsum(crowd, 0, dtype=torch.int32) - 1
    return out, ok


def _crowding(cols, hints, n: int):
    """``derive_crowding_hints`` in slot space, entry k for slot k+1:
    ``(crowded, ok)``; ``ok`` holds where the batch has no delete and
    each check of the NumPy statement holds on every used slot."""
    win_row = hints["win_row"]
    used = win_row < n
    row = torch.where(used, win_row, 0)
    ts = cols["ts"]
    depth = cols["depth"].to(torch.int32)
    pf = hints["parent_sl"].index_select(0, row)
    af = hints["at_sl"].index_select(0, row)
    psl, asl = pf >> 1, af >> 1
    afd = (af & 1) != 0
    slots = torch.arange(1, n + 1, dtype=torch.int32, device=row.device)
    anchor_sent = cols["anchor_ts"].index_select(0, row) == 0
    # causal anchors, every parent resolved, every timestamp real
    good = (anchor_sent | (afd & (asl >= 1) & (asl < slots))) & \
        ((pf & 1) != 0) & (ts.index_select(0, row) > 0)
    root_par = psl == 0
    par_row = torch.where(
        root_par, 0, win_row.index_select(0, (psl - 1).clamp(0, n - 1)))
    good &= root_par | (par_row < n)
    par_c = par_row.clamp(0, n - 1)
    d = depth.index_select(0, row)
    pd = torch.where(root_par, 0, depth.index_select(0, par_c))
    D = int(cols["paths"].shape[1])
    good &= (d >= 1) & (d <= D) & (d == pd + 1)
    if D > 1:
        # the claimed prefix equals the parent's materialised path (with
        # D == 1 the depth check above already leaves no prefix to hold)
        paths = cols["paths"]
        cpos = torch.arange(D, device=row.device)
        pp = torch.where(root_par[:, None], 0, paths.index_select(0, par_c))
        pts = torch.where(root_par, 0, ts.index_select(0, par_c))
        par_mat = torch.where(cpos == (pd - 1)[:, None], pts[:, None], pp)
        good &= torch.all(torch.where(cpos < (d - 1)[:, None],
                                      paths.index_select(0, row) == par_mat,
                                      True), dim=1)
    # the anchor is a sibling
    a_par = hints["anchor_psl"].index_select(0, row) >> 1
    good &= anchor_sent | (afd & (a_par == psl) & (asl != 0))
    ok = torch.all(~used | good) & ~torch.any(cols["kind"] == KIND_DELETE)
    # the order forest is elementwise; crowding is one histogram
    star = torch.where(anchor_sent, psl, asl)
    cnt = add_drop(n + 2, torch.where(used, star, n + 2))
    crowded = used & (cnt.index_select(0, star) >= 2)
    return crowded, ok
