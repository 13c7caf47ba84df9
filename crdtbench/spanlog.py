"""The traced steps in the program's span log
(``crdt_graph_tpu_torch.utils.profiling.span_log``), for the per-layer
metrics that read spans and counts from it
(``crdtbench/metrics/*_per_step.py``, ``index_rows_per_lookup``,
``h2d_bytes_per_op``).  The log records while the window's profiler
runs, so its steps are the window's traced steps.  A step is the tree
under one top-level span, ``root``: a catch-up step's by default; a
reader of another path names its own."""

STEP = "engine.apply_packed"


def steps(rec, root: str = STEP):
    """(records inside the traced steps' span trees, step count); None
    for a program without a span log, an empty or overrun log, or one
    whose steps are not the traced steps."""
    try:
        from crdt_graph_tpu_torch.utils.profiling import span_log
    except ImportError:
        return None
    log = span_log()
    roots = {r["id"] for r in log["records"]
             if r["name"] == root and r["parent"] is None}
    if log["dropped"] or not roots \
            or len(roots) != len(rec["window"]["traced_ops"]):
        return None
    return [r for r in log["records"] if r["root"] in roots], len(roots)


def ms(recs, keep) -> float:
    """Milliseconds of the records for which ``keep(record)`` holds."""
    return sum(r["end_ns"] - r["start_ns"] for r in recs if keep(r)) / 1e6


def ms_per_step(rec, name: str, root: str = STEP):
    """Milliseconds a traced step spends in the spans ``name``; None as
    :func:`steps`."""
    got = steps(rec, root)
    if got is None:
        return None
    recs, n = got
    return ms(recs, lambda r: r["name"] == name) / n


def counted(recs, name: str) -> int:
    """The count ``name`` summed over ``recs``."""
    return sum(r["counts"].get(name, 0) for r in recs)
