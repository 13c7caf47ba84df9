"""Milliseconds a traced catch-up step spends building the state's
timestamp index (``packed.ts_index``: two sorted arrays from one
``argsort`` over the log's adds, to resolve the delta's references),
from the program's span log."""

from crdtbench import spanlog


def read(rec):
    return spanlog.ms_per_step(rec, "packed.ts_index")
