"""Bytes the traced steps copied host to device
(``convert.h2d_bytes``, the padded columns sent) over the operations
they merged, from the program's span log."""

from crdtbench import spanlog


def read(rec):
    got = spanlog.steps(rec)
    if got is None:
        return None
    recs, _ = got
    return spanlog.counted(recs, "convert.h2d_bytes") \
        / sum(rec["window"]["traced_ops"])
