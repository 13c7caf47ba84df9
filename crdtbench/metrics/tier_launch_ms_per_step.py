"""Milliseconds a traced remote merge spends in the merge worker's epoch
launch (``mergetier.launch``: ``stack_aligned``, the batched merge on
the card and the one read-back), from the program's span log."""

from crdtbench import spanlog


def read(rec):
    return spanlog.ms_per_step(rec, "mergetier.launch",
                               root="mergetier.merge_one")
