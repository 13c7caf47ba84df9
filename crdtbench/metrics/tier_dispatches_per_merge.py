"""Device ops of one audited remote merge of the cell's own inputs (the
merge worker's batched merge, on the join leg), outside the window:
read as ``dispatches_per_merge`` reads the catch-up cell's."""
from crdtbench import run


def read(rec):
    return run.read_metric("dispatches_per_merge", rec)
