"""Milliseconds a traced catch-up step spends in the log ∪ delta concat
(``packed.concat``: column copies, link shifts, reference lookups and
the union's ranks) less the timestamp index built inside it, from the
program's span log."""

from crdtbench import spanlog


def read(rec):
    got = spanlog.steps(rec)
    if got is None:
        return None
    recs, steps = got
    concat = {r["id"] for r in recs if r["name"] == "packed.concat"}
    return (spanlog.ms(recs, lambda r: r["id"] in concat)
            - spanlog.ms(recs, lambda r: r["name"] == "packed.ts_index"
                         and r["parent"] in concat)) / steps
