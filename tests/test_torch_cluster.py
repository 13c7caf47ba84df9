"""The port's replica fleet, held to the reference's.

Two patterns:

- **Replay**: each test of ``tests/test_cluster.py`` but those marked
  slow and those that need the load generator (``NEEDS_MORE``) runs
  again with
  its names pointed at the port (``FleetServer`` builds its engine with
  ``device="cpu"``): the KV contracts, the ring, the lease protocol, the
  anti-entropy windows and the in-process fleet's forwarding, failover
  and rejoin.
- **Lockstep**: one scripted session drives a 3-node reference fleet
  and a 3-node port fleet (``MemoryKV`` each) through the same requests:
  replica ids, writes entering through non-primary nodes (forwarded),
  a delete, a kernel-sized bootstrap, anti-entropy rounds in a fixed
  order, and replica-local reads.  Every response must agree in status,
  body and every header but the timing ones, and every replica's
  ``state_fingerprint`` must equal the reference replica's.

Also: ring placement and lease ids and fencing tokens equal the
reference's for the same membership.
"""
import functools
import json
import types
from http.client import HTTPConnection

import pytest

import test_cluster as ref  # noqa: E402 — configures JAX for the CPU
import _torch_replay  # noqa: E402

from crdt_graph_tpu import cluster as jcluster  # noqa: E402
from crdt_graph_tpu.codec import json_codec as jjson  # noqa: E402
from crdt_graph_tpu.core import operation as jop  # noqa: E402

import crdt_graph_tpu_torch.cluster as tcluster  # noqa: E402
from crdt_graph_tpu_torch import engine as tengine  # noqa: E402
from crdt_graph_tpu_torch.cluster import kv as tkv  # noqa: E402
from crdt_graph_tpu_torch.codec import json_codec as tjson  # noqa: E402
from crdt_graph_tpu_torch.codec import packed as tpacked  # noqa: E402
from crdt_graph_tpu_torch.core import operation as top  # noqa: E402
from crdt_graph_tpu_torch.obs import prom as tprom  # noqa: E402

# tests marked slow (a subprocess fleet, the headline run) and those
# that need the reference's load generator
NEEDS_MORE = {"test_fleet_soak_sigkill_primary_mid_merge",
              "test_fleet_headline_full", "test_fleet_loadgen_smoke"}
REQ_S = 60
TIMING = {"Date", "Server", "X-Ae-Lag-Seconds"}

TENGINE = types.SimpleNamespace(
    init=functools.partial(tengine.init, device="cpu"),
    packed_since_window=tengine.packed_since_window,
    packed_since_bytes=tengine.packed_since_bytes)


@pytest.mark.parametrize("name,index",
                         _torch_replay.cases(ref, NEEDS_MORE))
def test_cluster_test_passes_on_port(name, index, tmp_path, monkeypatch):
    _torch_replay.run(ref, name, index, tmp_path, monkeypatch, names=(
        ("engine", TENGINE),
        ("FileKV", tcluster.FileKV),
        ("FleetServer", functools.partial(tcluster.FleetServer,
                                          device="cpu")),
        ("HashRing", tcluster.HashRing),
        ("LeaseError", tcluster.LeaseError),
        ("LeaseLost", tcluster.LeaseLost),
        ("LeaseService", tcluster.LeaseService),
        ("MemoryKV", tcluster.MemoryKV),
        ("kv_mod", tkv),
        ("json_codec", tjson),
        ("packed_mod", tpacked),
        ("Add", top.Add), ("Batch", top.Batch), ("Delete", top.Delete),
        ("prom_mod", tprom)))


# -- placement and leases ----------------------------------------------------


def test_ring_placement_equals_reference():
    for members in ({"a": "h:1"}, {"n0": "x:1", "n1": "x:2", "n2": "x:3"},
                    {f"node{i}": f"10.0.0.{i}:80" for i in range(7)}):
        for vnodes in (1, 64):
            jr = jcluster.HashRing(members, vnodes=vnodes)
            tr = tcluster.HashRing(members, vnodes=vnodes)
            docs = [f"doc{i}" for i in range(400)]
            assert [tr.primary(d) for d in docs] == \
                [jr.primary(d) for d in docs]
            assert tr.spread(docs) == jr.spread(docs)
            for m in members:
                assert tr.address(m) == jr.address(m)


def test_lease_ids_and_tokens_equal_reference():
    now = [1000.0]

    def clock():
        return now[0]

    def session(mod):
        svc = mod.LeaseService(mod.MemoryKV(), ttl_s=5.0, max_ids=4,
                               clock=clock)
        now[0] = 1000.0
        out = []
        for name in ("n0", "n1", "n2"):
            ls = svc.acquire(name, f"h:{name}")
            out.append((ls.name, ls.id, ls.token, ls.expires))
        out.append(tuple(sorted((n, ls.id, ls.token)
                                for n, ls in svc.members().items())))
        # n1 crashes: its slot expires and is reclaimed under its name
        # with a bumped fencing token; n3 takes the free slot
        assert svc.expire_now("n1")
        ls = svc.acquire("n1", "h:n1b")
        out.append((ls.name, ls.id, ls.token))
        ls = svc.acquire("n3", "h:n3")
        out.append((ls.name, ls.id, ls.token))
        now[0] += 10.0
        out.append(tuple(sorted(svc.members())))
        return out

    assert session(tcluster) == session(jcluster)


# -- the lockstep fleet session ----------------------------------------------


def _call(port, method, path, body=None, headers=None):
    conn = HTTPConnection("127.0.0.1", port, timeout=REQ_S)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, raw, {k: v for k, v in resp.getheaders()
                                  if k not in TIMING}
    finally:
        conn.close()


def _fleet(mod, **kw):
    kv = mod.MemoryKV()
    fleet = {n: mod.FleetServer(n, kv, ttl_s=600.0, ae_interval_s=3600.0,
                                **kw)
             for n in ("n0", "n1", "n2")}
    for fs in fleet.values():
        fs.node.refresh_ring()
    return fleet


def _chain(op_mod, codec, rid, n, start=1, prev=0):
    ops = []
    for c in range(start, start + n):
        ops.append(op_mod.Add(rid * 2**32 + c, (prev,), f"r{rid}:{c}"))
        prev = rid * 2**32 + c
    return codec.dumps(op_mod.Batch(tuple(ops)))


def _session_steps(op_mod, codec, ring):
    """The scripted requests: (node, method, path, body, headers)."""
    docs = {}
    for owner in ("n0", "n1", "n2"):
        docs[owner] = next(f"doc{i}" for i in range(500)
                           if ring.primary(f"doc{i}") == owner)
    steps = []
    for owner, doc in sorted(docs.items()):
        for node in ("n0", "n1", "n2"):
            steps.append((node, "POST", f"/docs/{doc}/replicas", None, {}))
    k = 0
    for owner, doc in sorted(docs.items()):
        for node in ("n0", "n1", "n2"):
            if node == owner:
                continue       # every write here enters a non-primary
            k += 1
            rid = 10 + k
            hdr = {"X-Trace-Id": f"lockstep-{k:010d}",
                   "X-Session-Id": f"sess-{k:010d}",
                   "Content-Type": "application/json"}
            steps.append((node, "POST", f"/docs/{doc}/ops",
                          _chain(op_mod, codec, rid, 6), hdr))
            if k == 2:
                dels = codec.dumps(op_mod.Batch((op_mod.Delete(
                    ((rid * 2**32 + 3),)),)))
                steps.append((node, "POST", f"/docs/{doc}/ops", dels,
                              dict(hdr, **{"X-Trace-Id":
                                           "lockstep-del-0000"})))
    # a kernel-sized write (above the host-mirror threshold) forwarded
    big = docs["n2"]
    steps.append(("n0", "POST", f"/docs/{big}/ops",
                  _chain(op_mod, codec, 40, 1200),
                  {"X-Trace-Id": "lockstep-big-00000",
                   "X-Session-Id": "sess-big-000000"}))
    return docs, steps


def _drive(mod, op_mod, codec, **kw):
    fleet = _fleet(mod, **kw)
    out = []
    try:
        ring = fleet["n0"].node.ring()
        docs, steps = _session_steps(op_mod, codec, ring)
        for node, method, path, body, hdr in steps:
            out.append(("write", node, path) + _call(
                fleet[node].port, method, path, body, hdr))
        for _ in range(2):
            for node in ("n0", "n1", "n2"):
                fleet[node].node.antientropy.sync_now()
        reader = {"X-Session-Id": "sess-reader-0000"}
        for doc in sorted(docs.values()):
            for node in ("n0", "n1", "n2"):
                out.append(("read", node, doc) + _call(
                    fleet[node].port, "GET", f"/docs/{doc}",
                    headers=reader))
                out.append(("ops", node, doc) + _call(
                    fleet[node].port, "GET", f"/docs/{doc}/ops?since=0",
                    headers=reader))
        placement = {d: ring.primary(d) for d in docs.values()}
        members = {n: (ls.id, ls.token) for n, ls in
                   fleet["n0"].node.members().items()}
    finally:
        for fs in fleet.values():
            fs.stop()
    return out, placement, members


def test_fleet_session_lockstep_with_reference():
    jout, jplace, jmembers = _drive(jcluster, jop, jjson)
    tout, tplace, tmembers = _drive(tcluster, top, tjson, device="cpu")
    assert tplace == jplace and tmembers == jmembers
    assert len(tout) == len(jout)
    fps = set()
    for j, t in zip(jout, tout):
        kind, node, path, jst, jraw, jhdr = j
        assert t[:3] == j[:3]
        _, _, _, tst, traw, thdr = t
        assert tst == jst, (j[:3], jraw, traw)
        if kind == "write" and path.endswith("/replicas"):
            assert json.loads(traw) == json.loads(jraw), j[:3]
        else:
            assert traw == jraw, j[:3]
        assert thdr == jhdr, j[:3]
        if kind == "write" and path.endswith("/ops"):
            # forwarded: the primary answered, with the client's ids
            assert json.loads(traw)["served_by"]["name"] != node
        if kind == "read":
            fps.add((path, thdr["X-State-Fingerprint"]))
    # converged: one fingerprint per document across the three replicas
    assert len(fps) == len({p for p, _ in fps}) == 3
