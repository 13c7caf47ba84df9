"""The port's merge tier, held to the reference's.

- **Replay**: each test of ``tests/test_mergetier.py`` but the one
  marked slow (``NEEDS_MORE``) runs again with its names pointed at the
  port (``MergeWorker`` and ``ServingEngine`` on ``device="cpu"``; the
  in-body ``cluster`` and ``bench.loadgen`` imports resolve to the
  port's): the wire codec, the linger batcher, remote == local commits
  over both transports, dead workers, digest mismatches, breakers, the
  kill switch, the ``mid-remote-merge`` crash leg, a netchaos cut on
  the merge link, the prom families, the worker registry, and a
  closed-loop load-generator run with the tier armed.
- **Wire**: request and frame bytes and digests equal the reference's
  for the same input, and each package decodes the other's.
- **Epochs**: one epoch of four riders of different sizes, its
  membership fixed (the riders wait on a barrier; ``max_width`` is 4
  and the linger long), gives every rider a frame equal field for field
  and byte for byte to the reference worker's.
- **Cross-package transports**: a port front-end against the reference
  worker and a reference front-end against the port worker commit
  bit-identical tables, and the same state (``state_fingerprint``,
  values, wire bytes, applied masks) as local merges in both packages.
- **The fallback ladder**: each rung (``transport``, ``timeout``,
  ``http_status``, ``wire``, ``digest``, ``dry_check``) is counted once
  and the document commits the local merge's table.
- **The kill switch**: ``GRAFT_MERGETIER=0`` and the armed tier commit
  the same state; only the armed side reaches the worker.

The zip clock is frozen so npz bytes compare.
"""
import functools
import socket
import threading
import time
import types
import zipfile

import numpy as np
import pytest

import test_mergetier as ref  # noqa: E402 — configures JAX for the CPU
import _torch_replay  # noqa: E402

from crdt_graph_tpu.codec import json_codec as jjson  # noqa: E402
from crdt_graph_tpu.codec import packed as jpacked  # noqa: E402
from crdt_graph_tpu.core import operation as jop  # noqa: E402
from crdt_graph_tpu.mergetier import client as jclient  # noqa: E402
from crdt_graph_tpu.mergetier import wire as jwire  # noqa: E402
from crdt_graph_tpu.mergetier import worker as jworker  # noqa: E402
from crdt_graph_tpu.serve import ServingEngine as JEngine  # noqa: E402

from crdt_graph_tpu_torch.cluster import kv as tkv  # noqa: E402
from crdt_graph_tpu_torch.cluster import mergepool as tpool  # noqa: E402
from crdt_graph_tpu_torch.cluster import netchaos as tnc  # noqa: E402
from crdt_graph_tpu_torch.codec import json_codec as tjson  # noqa: E402
from crdt_graph_tpu_torch.codec import packed as tpacked  # noqa: E402
from crdt_graph_tpu_torch.core import operation as top  # noqa: E402
from crdt_graph_tpu_torch.mergetier import client as tclient  # noqa: E402
from crdt_graph_tpu_torch.mergetier import wire as twire  # noqa: E402
from crdt_graph_tpu_torch.mergetier import worker as tworker  # noqa: E402
from crdt_graph_tpu_torch.obs import flight as tflight  # noqa: E402
from crdt_graph_tpu_torch.obs import prom as tprom  # noqa: E402
from crdt_graph_tpu_torch.ops.merge import FIELDS  # noqa: E402
from crdt_graph_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from crdt_graph_tpu_torch.serve import SchedulerStopped  # noqa: E402
from crdt_graph_tpu_torch.serve import ServingEngine as TEngine  # noqa: E402

# the test marked slow (the headline run of a reference script)
NEEDS_MORE = {"test_bench_mergetier_headline_full"}
OFF = 2**32
N = 1200            # above the kernel crossover, one chunk
GIANT = 4200        # at or above GRAFT_MERGETIER_MIN_OPS (4096)

TWorker = functools.partial(tworker.MergeWorker, device="cpu")
TServing = functools.partial(TEngine, device="cpu")


@pytest.fixture(autouse=True)
def _frozen_zip_clock(monkeypatch):
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: 1_700_000_000.0, localtime=time.localtime))


@pytest.mark.parametrize("name,index",
                         _torch_replay.cases(ref, NEEDS_MORE))
def test_mergetier_test_passes_on_port(name, index, tmp_path,
                                       monkeypatch):
    _torch_replay.run(ref, name, index, tmp_path, monkeypatch, names=(
        ("json_codec", tjson),
        ("packed_mod", tpacked),
        ("Add", top.Add), ("Batch", top.Batch),
        ("client_mod", tclient),
        ("wire", twire),
        ("MergeWorker", TWorker),
        ("MergeWorkerServer", functools.partial(
            tworker.MergeWorkerServer, device="cpu")),
        ("flight_mod", tflight),
        ("prom_mod", tprom),
        ("mesh_mod", tmesh),
        ("ServingEngine", TServing),
        ("SchedulerStopped", SchedulerStopped)), modules=(
        ("crdt_graph_tpu.cluster.netchaos", tnc),
        ("crdt_graph_tpu.cluster.mergepool", tpool),
        ("crdt_graph_tpu.cluster.kv", tkv),
        (_torch_replay.LOADGEN, _torch_replay.port_loadgen())))


# -- inputs -----------------------------------------------------------------


def chain_ops(op_mod, rid, n, counter0=0, anchor=0, dels=0):
    ops, prev = [], anchor
    for i in range(n):
        ts = rid * OFF + counter0 + i + 1
        ops.append(op_mod.Add(ts, (prev,), (counter0 + i) & 0xFF))
        prev = ts
    # every dels-th node deleted (a delete-carrying candidate set)
    for i in range(dels, n, dels) if dels else ():
        ops.append(op_mod.Delete((rid * OFF + counter0 + i,)))
    return ops


# four riders of different sizes, replica ids and capacity buckets
RIDERS = ((2, 700, 0), (3, 1500, 16), (4, 2100, 0), (5, 3000, 9))


def packed_riders(op_mod, packed_mod):
    return [packed_mod.pack(chain_ops(op_mod, rid, n, dels=d))
            for rid, n, d in RIDERS]


def _fields(table):
    return {f: np.asarray(getattr(table, f)) for f in FIELDS}


def _assert_tables_equal(a, b, tag):
    fa, fb = _fields(a), _fields(b)
    for f in FIELDS:
        assert fa[f].dtype == fb[f].dtype, (tag, f)
        assert np.array_equal(fa[f], fb[f]), (tag, f)


# -- the wire ---------------------------------------------------------------


def test_wire_bytes_and_digests_equal_both_ways():
    tps, jps = packed_riders(top, tpacked), packed_riders(jop, jpacked)
    for i, (tp, jp) in enumerate(zip(tps, jps)):
        assert twire.request_digest(tp) == jwire.request_digest(jp)
        tbody = twire.encode_request(f"d{i}", tp, tp.num_ops)
        jbody = jwire.encode_request(f"d{i}", jp, jp.num_ops)
        assert tbody == jbody, i
        # traced requests carry the same extra key in both
        ctx = {"trace_ids": ["t1"], "span_ctx": "n0;remote_merge;1"}
        assert twire.encode_request(f"d{i}", tp, 5, trace_meta=ctx) \
            == jwire.encode_request(f"d{i}", jp, 5, trace_meta=ctx)
        # each package decodes the other's request
        p2, meta = twire.decode_request(jbody)
        q2, jmeta = jwire.decode_request(tbody)
        assert meta == jmeta and p2.capacity == q2.capacity
        for k, v in p2.arrays().items():
            assert np.array_equal(v, np.asarray(q2.arrays()[k])), (i, k)
    # frames: one real worker answer re-encoded by both codecs
    w = TWorker(linger_ms=0.0, name="wire-w")
    try:
        body = twire.encode_request("d0", tps[0], tps[0].num_ops)
        status, resp, _ = w.handle_merge(body)
        assert status == 200
        table, meta = twire.decode_response(resp)
        jtable, jmeta = jwire.decode_response(resp)
        assert meta == jmeta
        assert twire.frame_digest(table) == jwire.frame_digest(jtable)
        _assert_tables_equal(table, jtable, "decoded")
        assert jwire.encode_response(
            jtable, meta["shared_capacity"], meta["width"],
            meta["input_digest"]) == resp
        extra = {"worker": "w", "worker_ms": {"wait": 1.0}}
        assert twire.encode_response(
            table, meta["shared_capacity"], 1, meta["input_digest"],
            extra=extra) == jwire.encode_response(
            jtable, meta["shared_capacity"], 1, meta["input_digest"],
            extra=extra)
    finally:
        w.close()


def _epoch(worker, bodies):
    """Every body into ``worker.handle_merge`` from its own thread, the
    threads released together: one epoch of ``len(bodies)`` riders."""
    gate = threading.Barrier(len(bodies))
    out = [None] * len(bodies)

    def ride(i):
        gate.wait(30)
        out[i] = worker.handle_merge(bodies[i])

    ths = [threading.Thread(target=ride, args=(i,), daemon=True)
           for i in range(len(bodies))]
    for t in ths:
        t.start()
    for t in ths:
        t.join(300)
    assert not any(t.is_alive() for t in ths)
    return out


def test_epoch_of_four_riders_equals_reference_worker():
    bodies = [twire.encode_request(f"d{i}", p, p.num_ops)
              for i, p in enumerate(packed_riders(top, tpacked))]
    tw = TWorker(linger_ms=60_000.0, max_width=len(bodies), name="pw")
    jw = jworker.MergeWorker(linger_ms=60_000.0, max_width=len(bodies),
                             name="pw")
    try:
        tout, jout = _epoch(tw, bodies), _epoch(jw, bodies)
    finally:
        tw.close()
        jw.close()
    assert tw.stats()["batcher"]["launches"] == 1
    assert jw.stats()["batcher"]["launches"] == 1
    for i, ((ts_, tresp, _), (js, jresp, _)) in enumerate(zip(tout, jout)):
        assert ts_ == js == 200, i
        table, meta = twire.decode_response(tresp)
        jtable, jmeta = jwire.decode_response(jresp)
        assert meta["width"] == jmeta["width"] == len(bodies)
        assert meta == jmeta, i
        _assert_tables_equal(table, jtable, i)
        assert tresp == jresp, i


# -- cross-package transports ------------------------------------------------


def _round_bodies(codec, op_mod, wave):
    out = []
    for i in range(3):
        rid = i + 2
        c0 = wave * N
        out.append((f"x{i}", codec.dumps(op_mod.Batch(tuple(chain_ops(
            op_mod, rid, N, counter0=c0,
            anchor=(rid * OFF + c0) if c0 else 0))))))
    out.append(("g0", codec.dumps(op_mod.Batch(tuple(chain_ops(
        op_mod, 7, GIANT, counter0=wave * GIANT,
        anchor=(7 * OFF + wave * GIANT) if wave else 0))))))
    return out


def _session(engine, codec, op_mod):
    for wave in range(2):
        ref._push_staged(engine, _round_bodies(codec, op_mod, wave))
    return {d: engine.get(d) for d in ("x0", "x1", "x2", "g0")}


def test_cross_package_transports_commit_identical_tables():
    jw = jworker.MergeWorker(linger_ms=200.0, name="ref-w")
    tw = TWorker(linger_ms=200.0, name="port-w")
    tmt = tclient.MergeTierClient([jw], src="port-fe")
    jmt = jclient.MergeTierClient([tw], src="ref-fe")
    engines = {
        "port_fe": TServing(start=False, cross_doc=True, mergetier=tmt),
        "ref_fe": JEngine(start=False, cross_doc=True, mergetier=jmt),
        "port_local": TServing(start=False, cross_doc=True),
        "ref_local": JEngine(start=False, cross_doc=True)}
    try:
        docs = {}
        for name, eng in engines.items():
            port = name.startswith("port")
            docs[name] = _session(eng, tjson if port else jjson,
                                  top if port else jop)
        for mt in (tmt, jmt):
            st = mt.stats()
            assert st["remote_docs"] == 8 and not st["fallbacks"], st
        assert jw.stats()["merged_docs"] == 8
        assert tw.stats()["merged_docs"] == 8
        for d in ("x0", "x1", "x2", "g0"):
            base = docs["ref_local"][d]
            fp = base.read_view().state_fingerprint()
            for name in ("port_fe", "ref_fe", "port_local"):
                doc = docs[name][d]
                assert doc.read_view().state_fingerprint() == fp, \
                    (name, d)
                assert doc.snapshot() == base.snapshot(), (name, d)
                assert doc.dumps_since_bytes(0) == \
                    base.dumps_since_bytes(0), (name, d)
                assert np.array_equal(
                    np.asarray(doc.tree.last_applied_mask),
                    np.asarray(base.tree.last_applied_mask)), (name, d)
            # the committed tables: port front-end == reference
            # front-end, field for field (each merged by the OTHER
            # package's worker, in epochs of the same membership, so
            # at the same shared capacity)
            _assert_tables_equal(docs["port_fe"][d].tree.table(),
                                 docs["ref_fe"][d].tree.table(), d)
    finally:
        for eng in engines.values():
            eng.close()
        jw.close()
        tw.close()


# -- the fallback ladder, rung by rung ---------------------------------------


class _Stub:
    """A pool member whose answers break one rung of the ladder; the
    real worker behind it does the merging where a rung needs a real
    frame."""

    def __init__(self, rung):
        self.rung = rung
        self.name = f"stub-{rung}"
        self.real = TWorker(linger_ms=0.0, name=self.name)
        self.tiny = tpacked.pack(chain_ops(top, 9, 8))

    def handle_merge(self, body):
        if self.rung == "transport":
            raise ConnectionResetError("peer reset")
        if self.rung == "timeout":
            raise socket.timeout("timed out")
        if self.rung == "http_status":
            return 500, b'{"error": "boom"}', {}
        status, resp, hdr = self.real.handle_merge(body)
        assert status == 200
        if self.rung == "wire":
            return 200, resp[:len(resp) - 64], hdr
        table, meta = twire.decode_response(resp)
        if self.rung == "digest":
            return 200, twire.encode_response(
                table, meta["shared_capacity"], meta["width"],
                "0badc0ffee0badc0"), hdr
        # dry_check: a well-formed frame, bound to OUR request, of some
        # other (tiny) candidate set — its capacity is below ours
        _, tresp, _ = self.real.handle_merge(twire.encode_request(
            "tiny", self.tiny, self.tiny.num_ops))
        tiny, tmeta = twire.decode_response(tresp)
        return 200, twire.encode_response(
            tiny, tmeta["shared_capacity"], 1, meta["input_digest"]), hdr


@pytest.mark.parametrize("rung", ["transport", "timeout", "http_status",
                                  "wire", "digest", "dry_check"])
def test_each_fallback_rung_merges_locally(rung):
    stub = _Stub(rung)
    mt = tclient.MergeTierClient([stub], src=f"fe-{rung}")
    remote = TServing(start=False, mergetier=mt)
    local = TServing(start=False)
    body = [("g0", tjson.dumps(top.Batch(tuple(chain_ops(
        top, 5, GIANT, dels=7)))))]
    try:
        ref._push_staged(remote, body)
        ref._push_staged(local, body)
        ref._assert_docs_equiv(remote, local, ["g0"])
        _assert_tables_equal(remote.get("g0").tree.table(),
                             local.get("g0").tree.table(), rung)
        st = mt.stats()
        assert st["fallbacks"] == {rung: 1}, st
        assert st["remote_docs"] == 0
        assert remote.counters.get("mergetier_fallbacks") == 1
        assert st["workers"][0]["fail_streak"] == 1
    finally:
        remote.close()
        local.close()
        stub.real.close()


# -- the kill switch, both sides ---------------------------------------------


@pytest.mark.parametrize("killed", [True, False], ids=["killed", "armed"])
def test_kill_switch_both_sides_commit_the_same_state(killed,
                                                      monkeypatch):
    if killed:
        monkeypatch.setenv("GRAFT_MERGETIER", "0")
    else:
        monkeypatch.delenv("GRAFT_MERGETIER", raising=False)
    worker = TWorker(linger_ms=200.0, name="ks-w")
    eng = TServing(start=False, cross_doc=True, mergetier=[worker])
    local = TServing(start=False, cross_doc=True)
    try:
        assert (eng.mergetier is None) == killed
        for e in (eng, local):
            _session(e, tjson, top)
        ref._assert_docs_equiv(eng, local, ["x0", "x1", "x2", "g0"])
        fams = tprom.parse_text(eng.render_prom())
        tier_fams = [f for f in fams if f.startswith("crdt_mergetier_")]
        if killed:
            assert worker.stats()["requests"] == 0
            assert eng.scheduler_metrics()["mergetier"] is None
            assert not tier_fams
            assert eng.counters.get("cross_doc_batches") == 2
        else:
            assert worker.stats()["merged_docs"] == 8
            assert eng.scheduler_metrics()["mergetier"][
                "remote_docs"] == 8
            assert "crdt_mergetier_remote_docs_total" in tier_fams
            assert eng.counters.get("cross_doc_batches") == 0
    finally:
        eng.close()
        local.close()
        worker.close()
