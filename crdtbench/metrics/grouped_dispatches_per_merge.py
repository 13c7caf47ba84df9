"""Device ops of one audited grouped step of the cell's own inputs (one
batched merge of every document, on the join leg), outside the window:
read as ``dispatches_per_merge`` reads the catch-up cell's."""
from crdtbench import run


def read(rec):
    return run.read_metric("dispatches_per_merge", rec)
