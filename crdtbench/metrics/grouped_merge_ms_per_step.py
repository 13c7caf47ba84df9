"""Host milliseconds of a traced grouped step's one batched merge
(``merge.materialize`` under ``engine.apply_grouped``: the H2D copies of
the ``[B, N]`` columns, the stages' launches and the waits of their
predicate reads), from the program's span log."""

from crdtbench import spanlog


def read(rec):
    return spanlog.ms_per_step(rec, "merge.materialize",
                               root="engine.apply_grouped")
