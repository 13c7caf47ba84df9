"""Milliseconds a traced catch-up step spends deriving the candidate
set's slot hints (``packed.slot_hints``), from the program's span
log."""

from crdtbench import spanlog


def read(rec):
    return spanlog.ms_per_step(rec, "packed.slot_hints")
