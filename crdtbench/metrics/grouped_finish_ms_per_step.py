"""Milliseconds a traced grouped step spends committing its documents
(the B ``engine.finish_packed`` spans: each document's status read-back
from its slice of the batched table, then clocks, log and view), from
the program's span log."""

from crdtbench import spanlog


def read(rec):
    return spanlog.ms_per_step(rec, "engine.finish_packed",
                               root="engine.apply_grouped")
