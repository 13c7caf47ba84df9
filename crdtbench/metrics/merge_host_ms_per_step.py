"""Host milliseconds of a traced catch-up step's bulk merge
(``merge.materialize``: the H2D copies, the stages' launches and the
waits of their predicate reads), from the program's span log."""

from crdtbench import spanlog


def read(rec):
    return spanlog.ms_per_step(rec, "merge.materialize")
