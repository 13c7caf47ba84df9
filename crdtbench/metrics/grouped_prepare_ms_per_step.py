"""Milliseconds a traced grouped step spends preparing its documents'
candidate sets (the B ``engine.prepare_packed`` spans, each the log ∪
delta concat with the state's timestamp index), from the program's span
log."""

from crdtbench import spanlog


def read(rec):
    return spanlog.ms_per_step(rec, "engine.prepare_packed",
                               root="engine.apply_grouped")
