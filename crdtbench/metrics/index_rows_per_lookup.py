"""Rows the traced steps' timestamp indexes were built over
(``packed.index_rows``) per reference resolved through them
(``packed.index_lookups``): the index's waste, from the program's span
log."""

from crdtbench import spanlog


def read(rec):
    got = spanlog.steps(rec)
    if got is None:
        return None
    recs, _ = got
    lookups = spanlog.counted(recs, "packed.index_lookups")
    return spanlog.counted(recs, "packed.index_rows") / lookups \
        if lookups else None
