"""Traffic drivers.  A traffic file names its driver (``"driver"``); the
driver builds the cell's state from the configuration and the seed at
set-up, drives the program in a closed loop through one measured window,
and hands back what the window produced for the check.

Each driver module exposes ``Driver(config, traffic, seed, device,
trace)`` with the methods of :data:`INTERFACE`: ``inputs()`` and
``checked()`` (the cell's inputs from the seed, and the candidate
columns of every answer the check compares, which the control reads
too), ``setup()``, ``window(seconds, tracer)``, ``host_tables()`` and
``check()``, and for traced runs ``spans()``, ``audit()`` and
``kernel_bound_ms()`` (see :mod:`crdtbench.run`).  A driver's
timed-path faults are ``crdtbench/tests/faults/<driver>.py``.
"""
from __future__ import annotations

import importlib

INTERFACE = ("inputs", "checked", "setup", "window", "host_tables",
             "check", "spans", "audit", "kernel_bound_ms")


def load(name: str):
    return importlib.import_module(f"crdtbench.drivers.{name}").Driver


def packed_of(cols: dict, values: list):
    """Op columns → the program's ``PackedOps`` at its power-of-two
    capacity, link hints vouched (every in-batch reference resolved, as
    the program's own parser vouches for a decoded ``/ops`` window)."""
    from crdt_graph_tpu_torch.codec import packed as packed_mod
    n = int(cols["ts"].shape[0])
    cap = 8
    while cap < n:
        cap *= 2
    a = packed_mod.pad_arrays(cols, cap)
    return packed_mod.PackedOps(
        kind=a["kind"], ts=a["ts"], parent_ts=a["parent_ts"],
        anchor_ts=a["anchor_ts"], depth=a["depth"], paths=a["paths"],
        value_ref=a["value_ref"], pos=a["pos"], values=values, num_ops=n,
        parent_pos=a["parent_pos"], anchor_pos=a["anchor_pos"],
        target_pos=a["target_pos"], hints_vouched=True)
