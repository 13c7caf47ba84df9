"""The comparison that decides ``correct``: a merged table the program
returned, read as plain NumPy, against :func:`crdtbench.reference.rga.
converge` of the same op columns.

Three counts, each held to the limit 0 (an exact comparison):

- ``order``: positions of the visible document order whose node
  timestamp differs, plus the difference in length;
- ``shape``: positions whose node depth or parent timestamp differs;
- ``status``: ops whose status differs.
"""
from __future__ import annotations

import numpy as np

from . import rga

LIMITS = {"order_mismatches": 0, "shape_mismatches": 0,
          "status_mismatches": 0}


def table_view(ts, visible_order, num_visible, depth, parent, status,
               n: int) -> dict:
    """The program's table (host arrays of its fields) in the
    reference's terms: visible nodes in document order with their depth
    and parent timestamp, and the first ``n`` per-op statuses."""
    ts = np.asarray(ts)
    k = int(np.asarray(num_visible))
    slots = np.asarray(visible_order)[:k].astype(np.int64)
    par = np.asarray(parent).astype(np.int64)
    return {"order_ts": ts[slots],
            "order_depth": np.asarray(depth)[slots].astype(np.int64),
            "order_parent_ts": ts[par[slots]],
            "status": np.asarray(status)[:n].astype(np.int8)}


def empty_view() -> dict:
    """What an answer that holds no table says: no nodes, no statuses."""
    z = np.zeros(0, np.int64)
    return {"order_ts": z, "order_depth": z, "order_parent_ts": z,
            "status": np.zeros(0, np.int8)}


def mismatches(got: dict, want: dict) -> dict:
    def diff(a, b):
        m = min(a.size, b.size)
        return int(np.count_nonzero(a[:m] != b[:m])) + abs(a.size - b.size)
    shape = diff(got["order_depth"], want["order_depth"])
    shape += diff(got["order_parent_ts"], want["order_parent_ts"])
    return {"order_mismatches": diff(got["order_ts"], want["order_ts"]),
            "shape_mismatches": shape,
            "status_mismatches": diff(got["status"], want["status"])}


def judge(got: dict, cols: dict, n: int,
          sibling_rule: str = "timestamp") -> dict:
    """Mismatch counts of ``got`` against the reference of ``cols``'s
    first ``n`` rows."""
    want = rga.converge(cols["kind"], cols["ts"], cols["depth"],
                        cols["paths"], n, sibling_rule=sibling_rule)
    return mismatches(got, want)


def add_up(counts: list) -> dict:
    out = {k: 0 for k in LIMITS}
    for c in counts:
        for k in out:
            out[k] += c[k]
    return out
