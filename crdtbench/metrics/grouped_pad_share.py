"""The share of the traced grouped steps' stacked rows that are padding,
in %: 100 x (1 - ``grouped.rows_live`` / ``grouped.rows_stacked``), the
counts of the ``grouped.stack`` spans (the candidate rows, and the
documents times the shared capacity), from the program's span log."""

from crdtbench import spanlog

ROOT = "engine.apply_grouped"


def read(rec):
    got = spanlog.steps(rec, ROOT)
    if got is None:
        return None
    recs, _ = got
    stacked = spanlog.counted(recs, "grouped.rows_stacked")
    if not stacked:
        return None
    return 100.0 * (1.0 - spanlog.counted(recs, "grouped.rows_live")
                    / stacked)
