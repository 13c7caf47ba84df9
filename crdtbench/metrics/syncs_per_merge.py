"""Counted predicate reads (``merge._read``, one stream sync each) of the
same audited merge."""


def read(rec):
    a = rec.get("audit")
    return a["read_syncs"] / max(1, a["merges"]) if a else None
