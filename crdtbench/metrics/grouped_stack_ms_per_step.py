"""Milliseconds a traced grouped step spends padding its documents'
candidate sets to the shared capacity and stacking them into ``[B, N]``
columns (``grouped.stack``: ``parallel.mesh.stack_aligned`` on the host),
from the program's span log."""

from crdtbench import spanlog


def read(rec):
    return spanlog.ms_per_step(rec, "grouped.stack",
                               root="engine.apply_grouped")
