"""The port's session-guarantee oracle and fault injection, held to the
reference's own tests.

Each test of ``tests/test_oracle.py`` that needs no server fixture and
no load generator runs again with that module's names pointed at the
port: ``obs.oracle``, ``obs.flight``, ``obs.prom``, the wire codec and
``ServingEngine(device="cpu")``.  The same assertions then hold the
port's ``SessionOracle`` checks, its ``FaultInjector`` faults through
the real engine, the oracle flight dumps, the flush barrier and the
``crdt_oracle_*`` prom families.
"""
import functools
import inspect

import pytest

import test_oracle as ref  # noqa: E402 — configures JAX for the CPU

from crdt_graph_tpu_torch.codec import json_codec as tjson  # noqa: E402
from crdt_graph_tpu_torch.core.operation import Add, Batch  # noqa: E402
from crdt_graph_tpu_torch.obs import flight as tflight  # noqa: E402
from crdt_graph_tpu_torch.obs import oracle as toracle  # noqa: E402
from crdt_graph_tpu_torch.obs import prom as tprom  # noqa: E402
from crdt_graph_tpu_torch.serve import ServingEngine as TEngine  # noqa: E402

# tests that need the reference's HTTP server, its load generator or a
# fixture of that module
NEEDS_MORE = {"test_fault_stale_over_http_via_read_headers",
              "test_read_headers_echo_snapshot_identity",
              "test_loadgen_smoke_zero_violations",
              "test_serve_headline_full"}
ARGS = {"tmp_path", "monkeypatch"}


def _replayed():
    for name, fn in sorted(vars(ref).items()):
        if name.startswith("test_") and name not in NEEDS_MORE \
                and set(inspect.signature(fn).parameters) <= ARGS:
            yield name


@pytest.mark.parametrize("name", list(_replayed()))
def test_oracle_test_passes_on_port(name, tmp_path, monkeypatch):
    for attr, port in (("json_codec", tjson), ("Add", Add),
                       ("Batch", Batch), ("flight_mod", tflight),
                       ("oracle_mod", toracle), ("prom_mod", tprom),
                       ("ServingEngine",
                        functools.partial(TEngine, device="cpu"))):
        monkeypatch.setattr(ref, attr, port)
    fn = getattr(ref, name)
    given = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn(**{a: given[a] for a in inspect.signature(fn).parameters})
