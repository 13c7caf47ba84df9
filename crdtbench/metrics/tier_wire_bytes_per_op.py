"""Bytes of the merge tier's request and response bodies
(``mergetier.wire_bytes``, counted where each body is made) over the
operations the traced remote merges carried, from the program's span
log."""

from crdtbench import spanlog


def read(rec):
    got = spanlog.steps(rec, "mergetier.merge_one")
    if got is None:
        return None
    recs, _ = got
    return spanlog.counted(recs, "mergetier.wire_bytes") \
        / sum(rec["window"]["traced_ops"])
