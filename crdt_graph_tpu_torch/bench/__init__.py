"""Workload generators and honest timing on the card."""
from . import workloads
