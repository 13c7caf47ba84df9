"""Benchmark harness: the workload generators, honest timing on the card,
the config runner and the serving benches."""
from . import workloads
