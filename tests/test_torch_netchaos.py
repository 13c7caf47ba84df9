"""The port's network fault injection, held to the reference's.

- **Replay**: each test of ``tests/test_netchaos.py`` but the one
  marked slow (``NEEDS_MORE``) runs again with its names pointed at the
  port (``FleetServer`` builds its engine with ``device="cpu"``; the
  in-body ``cluster.netchaos`` and ``bench.loadgen`` imports resolve to
  the port's): the spec grammar, seeded determinism, the partition/heal
  matrix, cuts and duplicated windows through the real anti-entropy
  wire, the peer breakers, the staleness contract, the forward budget,
  and the fleet load generator under chaos on the inter-node and the
  client links.
- **Lockstep**: the same spec and seed give the same fault-decision
  sequence in both packages, link by link: refusals, delays, cuts,
  duplicates and throttles, request by request.
"""
import functools

import pytest

import test_netchaos as ref  # noqa: E402 — configures JAX for the CPU
import _torch_replay  # noqa: E402

from crdt_graph_tpu.cluster import netchaos as jnc  # noqa: E402

import crdt_graph_tpu_torch.cluster as tcluster  # noqa: E402
from crdt_graph_tpu_torch.cluster import netchaos as tnc  # noqa: E402
from crdt_graph_tpu_torch.codec import json_codec as tjson  # noqa: E402
from crdt_graph_tpu_torch.core import operation as top  # noqa: E402

# the test marked slow (the multi-process soak)
NEEDS_MORE = {"test_fleet_soak_processes_under_netchaos"}


@pytest.mark.parametrize("name,index",
                         _torch_replay.cases(ref, NEEDS_MORE))
def test_netchaos_test_passes_on_port(name, index, tmp_path, monkeypatch):
    _torch_replay.run(ref, name, index, tmp_path, monkeypatch, names=(
        ("FleetServer", functools.partial(tcluster.FleetServer,
                                          device="cpu")),
        ("MemoryKV", tcluster.MemoryKV),
        ("NetChaos", tnc.NetChaos),
        ("NetChaosSpecError", tnc.NetChaosSpecError),
        ("json_codec", tjson),
        ("Add", top.Add), ("Batch", top.Batch)),
        modules=(("crdt_graph_tpu.cluster.netchaos", tnc),
                 (_torch_replay.LOADGEN, _torch_replay.port_loadgen())))


def _decisions(mod, seed, spec, links, n):
    """Each link's next ``n`` fates, drawn in a fixed interleaving:
    ``X`` for a refusal, else (delay, cut, dup, throttle)."""
    chaos = mod.NetChaos(seed, spec)
    out = []
    for i in range(n):
        for src, dst in links:
            try:
                plan = chaos.decide(src, dst)
            except ConnectionRefusedError:
                out.append((src, dst, i, "X"))
                continue
            out.append((src, dst, i, round(plan.delay_s, 9), plan.cut,
                        plan.dup, plan.throttle_bps))
    return out, chaos.stats()["counters"], chaos.describe()


@pytest.mark.parametrize("seed,spec", [
    (42, "drop=0.4;delay=0-0.0005@0.5;cut=0.2;dup=0.3"),
    (7, "cut=0.5;dup=0.5;throttle=65536"),
    (1337, "drop=0.1;delay=0.0001-0.0004@0.3;part=n0|n1+n2@3-9;"
           "oneway=n2>n0@0-4;flap=n1|n2@6/2"),
])
def test_fault_decisions_equal_reference(seed, spec):
    links = [("n0", "n1"), ("n1", "n0"), ("n1", "n2"), ("n2", "n0"),
             ("fe", "mergeworker")]
    tout, tcount, tdesc = _decisions(tnc, seed, spec, links, 24)
    jout, jcount, jdesc = _decisions(jnc, seed, spec, links, 24)
    assert tdesc == jdesc
    assert tout == jout
    assert tcount == jcount
    assert any(d[3] == "X" for d in tout) or "drop" not in spec
