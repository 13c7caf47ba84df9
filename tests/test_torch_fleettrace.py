"""The port's fleet tracing, visibility ledger and canary, held to the
reference's own tests.

Each test of ``tests/test_fleettrace.py`` but the one marked slow
(``NEEDS_MORE``) runs again with its names pointed at the port
(``FleetServer`` and ``ServingEngine`` on ``device="cpu"``): the span
rings, the ``X-Span-Ctx`` / ``X-Trace-Frontier`` wire helpers, the
merge request's trace meta, trace-id propagation through a forward, the
federated ``/debug/trace`` tree of a forwarded, watched, replicated
write on a durable fleet, the ledger's tail, the prom families and
their absence off the fleet, the canary under an injected link delay,
and ``GRAFT_FLEETTRACE=0``.
"""
import functools

import pytest

import test_fleettrace as ref  # noqa: E402 — configures JAX for the CPU
import _torch_replay  # noqa: E402

import crdt_graph_tpu_torch.cluster as tcluster  # noqa: E402
from crdt_graph_tpu_torch.cluster import netchaos as tnc  # noqa: E402
from crdt_graph_tpu_torch.codec import json_codec as tjson  # noqa: E402
from crdt_graph_tpu_torch.codec import packed as tpacked  # noqa: E402
from crdt_graph_tpu_torch.core import operation as top  # noqa: E402
from crdt_graph_tpu_torch.mergetier import wire as twire  # noqa: E402
from crdt_graph_tpu_torch.obs import canary as tcanary  # noqa: E402
from crdt_graph_tpu_torch.obs import fleettrace as tft  # noqa: E402
from crdt_graph_tpu_torch.obs import prom as tprom  # noqa: E402
from crdt_graph_tpu_torch.serve import ServingEngine as TEngine  # noqa: E402

# the one test marked slow (the headline run of a reference script)
NEEDS_MORE = {"test_bench_visibility_headline_full"}


@pytest.mark.parametrize("name,index",
                         _torch_replay.cases(ref, NEEDS_MORE))
def test_fleettrace_test_passes_on_port(name, index, tmp_path,
                                        monkeypatch):
    _torch_replay.run(ref, name, index, tmp_path, monkeypatch, names=(
        ("FleetServer", functools.partial(tcluster.FleetServer,
                                          device="cpu")),
        ("MemoryKV", tcluster.MemoryKV),
        ("netchaos_mod", tnc),
        ("json_codec", tjson),
        ("packed_mod", tpacked),
        ("Add", top.Add), ("Batch", top.Batch),
        ("wire", twire),
        ("canary_mod", tcanary),
        ("fleettrace_mod", tft),
        ("prom_mod", tprom),
        ("ServingEngine", functools.partial(TEngine, device="cpu"))))


def test_ledger_stamps_a_watch_delivery_that_beats_its_ack():
    """A parked watcher is woken by the publish, which comes before the
    commit's ledger stamp: that early delivery is held and stamped, at
    zero lag, by the ack that follows (its trace ids returned for the
    ``watch_delivery`` spans); a later delivery of the same generation
    is the fan-out, not the edge."""
    from crdt_graph_tpu_torch.obs.ledger import VisibilityLedger
    led = VisibilityLedger("n0")
    assert led.note_watch_delivery("d", 1) is None
    assert led.record_commit("d", 1, ("t1", "t2"), None, 3.0) == \
        ["t1", "t2"]
    assert led.watch_stamped == 1
    assert led.note_watch_delivery("d", 1) is None
    assert led.record_commit("d", 2, ("t3",), None, 1.0) is None
    assert led.note_watch_delivery("d", 2) == ["t3"]
    assert led.watch_stamped == 2
