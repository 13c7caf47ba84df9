"""Seconds from the start of the process to the start of the window:
imports, the card, the kernels' build or load, inputs, the base merge
and the warm-up."""


def read(rec):
    return rec["setup_s"]
