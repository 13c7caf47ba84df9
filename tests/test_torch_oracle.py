"""The port's session-guarantee oracle and fault injection, held to the
reference's own tests.

Each test of ``tests/test_oracle.py`` that needs no server fixture and
is not marked slow runs again with that module's names pointed at the
port: ``obs.oracle``, ``obs.flight``, ``obs.prom``, the wire codec,
``ServingEngine(device="cpu")`` and (imported in a test's body) the
load generator.  The same assertions then hold the port's
``SessionOracle`` checks, its ``FaultInjector`` faults through the real
engine, the oracle flight dumps, the flush barrier, the
``crdt_oracle_*`` prom families and a closed-loop load-generator run
against the port's HTTP server with zero violations.
"""
import functools
import inspect

import pytest

import test_oracle as ref  # noqa: E402 — configures JAX for the CPU
import _torch_replay  # noqa: E402

from crdt_graph_tpu_torch.codec import json_codec as tjson  # noqa: E402
from crdt_graph_tpu_torch.core.operation import Add, Batch  # noqa: E402
from crdt_graph_tpu_torch.obs import flight as tflight  # noqa: E402
from crdt_graph_tpu_torch.obs import oracle as toracle  # noqa: E402
from crdt_graph_tpu_torch.obs import prom as tprom  # noqa: E402
from crdt_graph_tpu_torch.serve import ServingEngine as TEngine  # noqa: E402

# tests that need a fixture of that module (the reference's HTTP
# server) and the one marked slow
NEEDS_MORE = {"test_fault_stale_over_http_via_read_headers",
              "test_read_headers_echo_snapshot_identity",
              "test_serve_headline_full"}
ARGS = {"tmp_path", "monkeypatch"}


def _replayed():
    for name, fn in sorted(vars(ref).items()):
        if name.startswith("test_") and name not in NEEDS_MORE \
                and set(inspect.signature(fn).parameters) <= ARGS:
            yield name


@pytest.mark.parametrize("name", list(_replayed()))
def test_oracle_test_passes_on_port(name, tmp_path, monkeypatch):
    _torch_replay.run(ref, name, None, tmp_path, monkeypatch, names=(
        ("json_codec", tjson), ("Add", Add), ("Batch", Batch),
        ("flight_mod", tflight), ("oracle_mod", toracle),
        ("prom_mod", tprom),
        ("ServingEngine", functools.partial(TEngine, device="cpu"))),
        modules=((_torch_replay.LOADGEN, _torch_replay.port_loadgen()),))
