"""Milliseconds of a traced catch-up step's commit
(``engine.finish_packed``: the status read-back, then clocks, log and
view), from the program's span log."""

from crdtbench import spanlog


def read(rec):
    return spanlog.ms_per_step(rec, "engine.finish_packed")
