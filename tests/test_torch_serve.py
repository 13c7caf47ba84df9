"""The port's serving engine against the reference's, on the CPU.

``crdt_graph_tpu.serve.ServingEngine`` and
``crdt_graph_tpu_torch.serve.ServingEngine(device="cpu")`` take the same
wire bodies in lockstep (one client, each push resolved before the
next).  After every push the two must agree on the answer (accepted,
applied echo, counts) and on the published snapshot: visible values,
commit seq, fingerprints, ETag, the encoded ``/ops`` bodies and windows,
the clock body and the flight record (keys, trace ids, outcome and
counts; timings differ by nature).  Same-bucket pushes staged into one
round group into one batched merge, whose documents equal the per-doc
merges.  A full queue answers 429 with ``Retry-After``; a client reads
its own write; ``flush()`` then ``close()`` leaves no thread running.
Durable engines (WAL sync ``commit``) are killed at crash sites and
recover, in both packages and across them; the group-commit sync
backends (``single``, ``workers``, ``uring`` where the kernel has it)
recover every acked write.

Every blocking call here carries its own timeout: submits
(``submit_timeout_s``), thread joins, ``flush`` and HTTP requests.
"""
import json
import os
import threading
import time
import types
import zipfile

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

torch.set_num_threads(1)

from crdt_graph_tpu import Add, Delete  # noqa: E402
from crdt_graph_tpu.codec import json_codec as jjson  # noqa: E402
from crdt_graph_tpu.core import operation as jop  # noqa: E402
from crdt_graph_tpu.core.operation import Batch  # noqa: E402
from crdt_graph_tpu.obs import flight as jflight  # noqa: E402
from crdt_graph_tpu.serve import ServingEngine as JEngine  # noqa: E402
from crdt_graph_tpu.serve import SchedulerStopped as JStopped  # noqa: E402

from crdt_graph_tpu_torch import engine as tengine  # noqa: E402
from crdt_graph_tpu_torch import wal as twal  # noqa: E402
from crdt_graph_tpu_torch.codec import json_codec as tjson  # noqa: E402
from crdt_graph_tpu_torch.core import operation as top  # noqa: E402
from crdt_graph_tpu_torch.obs import flight as tflight  # noqa: E402
from crdt_graph_tpu_torch.obs import prom as tprom  # noqa: E402
from crdt_graph_tpu_torch.serve import QueueFull  # noqa: E402
from crdt_graph_tpu_torch.serve import SchedulerStopped as TStopped  # noqa
from crdt_graph_tpu_torch.serve import ServingEngine as TEngine  # noqa: E402
from crdt_graph_tpu_torch.utils import uring as turing  # noqa: E402

OFF = 2**32
SUBMIT_S = 60.0          # every submit's own timeout
JOIN_S = 30.0


@pytest.fixture(autouse=True)
def _serving_env(monkeypatch):
    """Audit sampling off in both packages (their audits differ), so
    flight records compare; the npz zip clock frozen, so snapshot bytes
    do; no crash site armed."""
    monkeypatch.setenv("GRAFT_OBS_AUDIT_EVERY", "0")
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: 1_700_000_000.0, localtime=time.localtime))
    monkeypatch.delenv("GRAFT_CRASH_POINT", raising=False)
    monkeypatch.delenv("GRAFT_CRASH_EXIT", raising=False)


def chain(rid, n, start=1, anchor=None, tag=""):
    """n causally ordered adds from replica ``rid`` (reference objects)."""
    ops = []
    prev = (rid * OFF + start - 1 if start > 1 else 0) \
        if anchor is None else anchor
    for c in range(start, start + n):
        ts = rid * OFF + c
        ops.append(Add(ts, (prev,), f"{tag}{rid}.{c}"))
        prev = ts
    return ops


def body(ops):
    return jjson.dumps(Batch(tuple(ops)) if isinstance(ops, list) else ops)


class Pair:
    """A reference engine and a port engine with the same settings."""

    def __init__(self, **kw):
        kw.setdefault("submit_timeout_s", SUBMIT_S)
        self.j = JEngine(flight=jflight.FlightRecorder(), **kw)
        self.t = TEngine(flight=tflight.FlightRecorder(), device="cpu",
                         **kw)
        self.n = 0

    def push(self, doc, b, expect=True):
        self.n += 1
        tid = f"{self.n:016x}"
        jr = self.j.submit(doc, b, trace_id=tid)
        tr = self.t.submit(doc, b, trace_id=tid)
        assert jr[0] == tr[0] == expect
        assert jop.count(jr[1]) == top.count(tr[1])
        if jop.count(jr[1]) <= 4096:
            assert jjson.dumps(jr[1]) == tjson.dumps(tr[1])
        return tr

    def compare(self, doc):
        compare_docs(self.j.get(doc, create=False),
                     self.t.get(doc, create=False))

    def close(self):
        self.j.close()
        self.t.close()


def compare_docs(jd, td):
    js, ts = jd.snapshot_view(), td.snapshot_view()
    assert js.seq == ts.seq
    assert list(js.values) == list(ts.values)
    assert js.fingerprint() == ts.fingerprint()
    assert js.state_fingerprint() == ts.state_fingerprint()
    assert js.etag() == ts.etag()
    assert bytes(js.values_body()) == bytes(ts.values_body())
    assert bytes(js.clock_body()) == bytes(ts.clock_body())
    assert bytes(js.ops_since_bytes(0)) == bytes(ts.ops_since_bytes(0))
    assert js.checkpoint_bytes() == ts.checkpoint_bytes()
    newest = max([0] + [v for v in js.clock.values()])
    for since, limit in ((0, 0), (0, 7), (newest, 3), (12345, 5)):
        jb, jm = js.ops_since_window(since, limit)
        tb, tm = ts.ops_since_window(since, limit)
        assert bytes(jb) == bytes(tb), (since, limit)
        assert jm == tm, (since, limit)
    for k in ("ops_merged", "dup_absorbed", "batches_rejected",
              "num_visible", "log_length", "snapshot_seq",
              "chunks_launched"):
        assert jd.metrics()[k] == td.metrics()[k], k


_RECORD_KEYS = ("doc_id", "trace_ids", "outcome", "num_ops",
                "applied_ops", "dup_ops", "coalesce_width", "batch_width",
                "chunk_count", "snapshot_seq", "fingerprint", "audit",
                "error", "matz_hit")


def compare_flight(jrec, trec):
    jr, tr = jrec.records(), trec.records()
    assert len(jr) == len(tr)
    for a, b in zip(jr, tr):
        a, b = a.to_json(), b.to_json()
        assert sorted(a) == sorted(b)
        assert sorted(a["stages_ms"]) == sorted(b["stages_ms"])
        for k in _RECORD_KEYS:
            assert a[k] == b[k], k


def test_lockstep_session_matches_reference():
    """Host-path and kernel-path pushes, native-parsed bulk bodies,
    deletes, a duplicate and a causality gap, on two documents."""
    p = Pair(wire_fast_bytes=1 << 14, chunk_ops=1 << 10)
    try:
        r2 = chain(2, 1500)
        p.push("a", body(chain(1, 5)))
        p.compare("a")
        p.push("a", body(r2))                 # kernel route, 2 chunks
        p.compare("a")
        p.push("a", body([Delete((r2[3].ts,)), *chain(1, 3, start=6)]))
        p.compare("a")
        p.push("a", body(chain(1, 5)))        # pure duplicate
        p.compare("a")
        p.push("a", jjson.dumps(Add(7 * OFF + 1, (987654321,), "x")),
               expect=False)                  # causality gap: 409
        p.compare("a")
        dels = [Delete((r2[k].ts,)) for k in range(100, 1300, 7)]
        p.push("a", body(chain(3, 1200, anchor=r2[-1].ts) + dels))
        p.compare("a")
        p.push("b", body(chain(4, 900)))
        p.compare("b")
        assert p.t.get("a").tree.log_length > 2000
        assert p.j.flush(JOIN_S) and p.t.flush(JOIN_S)
        compare_flight(p.j.flight, p.t.flight)
        assert [r.trace_ids for r in p.t.flight.records()] == \
            [(f"{i:016x}",) for i in range(1, 8)]
    finally:
        p.close()


def _stage(engine, pushes):
    """Stage one delta per doc with the scheduler stopped, run one
    round in this thread, and resolve every submit."""
    boxes = []
    for k, (doc_id, b) in enumerate(pushes):
        engine.get(doc_id)
        box = {}
        tid = f"{len(b):08x}{k:08x}"

        def go(d=doc_id, b=b, box=box, tid=tid):
            try:
                box["r"] = engine.submit(d, b, trace_id=tid)
            except BaseException as e:   # noqa: BLE001 — test capture
                box["e"] = e

        th = threading.Thread(target=go, daemon=True)
        th.start()
        boxes.append((th, box))
    deadline = time.monotonic() + JOIN_S
    for doc_id, _ in pushes:
        while len(engine.get(doc_id).queue) < 1:
            assert time.monotonic() < deadline, "push never queued"
            time.sleep(0.002)
    assert engine.scheduler.step() == len(pushes)
    for th, box in boxes:
        th.join(JOIN_S)
        assert not th.is_alive() and "e" not in box, box
        assert box["r"][0]


def test_same_bucket_pushes_group_into_one_batched_merge():
    """Three same-bucket kernel pushes staged into one round become one
    batched merge in both packages; the documents equal the reference's
    and a per-doc (``cross_doc=False``) port engine's, and a second wave
    on the batched commit keeps equal."""
    n = 1500
    wave1 = [(f"x{i}", body(chain(i + 2, n))) for i in range(3)]
    wave2 = [(f"x{i}", body(chain(i + 2, n, start=n + 1)))
             for i in range(3)]
    p = Pair(start=False)
    plain = TEngine(start=False, cross_doc=False, device="cpu",
                    flight=tflight.FlightRecorder(),
                    submit_timeout_s=SUBMIT_S)
    try:
        for wave in (wave1, wave2):
            _stage(p.j, wave)
            _stage(p.t, wave)
            _stage(plain, wave)
            for d, _ in wave:
                p.compare(d)
                compare_docs(plain.get(d), p.t.get(d))
        assert p.t.counters.get("cross_doc_batches") == 2
        assert p.j.counters.get("cross_doc_batches") == 2
        assert p.t.counters.get("cross_doc_docs") == 6
        assert plain.counters.get("cross_doc_batches") == 0
        widths = [r.batch_width for r in p.t.flight.records()]
        assert widths == [3] * 6
        compare_flight(p.j.flight, p.t.flight)
        assert len(p.t.get("x0").snapshot()) == 2 * n
    finally:
        p.close()
        plain.close()


def test_full_queue_429_and_read_your_writes():
    from http.client import HTTPConnection
    from crdt_graph_tpu_torch.service import make_server

    busy = TEngine(start=False, max_queue_requests=0, device="cpu",
                   flight=tflight.FlightRecorder())
    with pytest.raises(QueueFull) as ei:
        busy.submit("q", body(chain(1, 2)))
    assert ei.value.retry_after_s >= 1
    srv = make_server(port=0, store=busy)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        conn = HTTPConnection("127.0.0.1", srv.server_port, timeout=30)
        conn.request("POST", "/docs/busy/ops", body=body(chain(1, 2)))
        resp = conn.getresponse()
        out = json.loads(resp.read())
        assert resp.status == 429
        assert int(resp.getheader("Retry-After")) >= 1
        assert out["retry_after_s"] >= 1 and "trace_id" in out
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
        busy.close()
        th.join(JOIN_S)
    eng = TEngine(device="cpu", flight=tflight.FlightRecorder(),
                  submit_timeout_s=SUBMIT_S)
    try:
        for k in range(1, 40, 8):
            ok, _ = eng.submit("ryw", body(chain(1, 8, start=k)))
            assert ok
            snap = eng.get("ryw").read_view()
            assert len(snap.values) == k + 7      # the write is visible
    finally:
        eng.close()


def test_concurrent_writers_every_acked_write_reads_back():
    """Stress: more writer threads than cores, a short switch interval,
    four documents: every acked write is in its document afterwards, in
    its writer's order, and each document equals a CPU replica that
    applies its ``/ops?since=0`` (a lost or reordered update breaks it)."""
    import sys
    eng = TEngine(device="cpu", flight=tflight.FlightRecorder(),
                  submit_timeout_s=SUBMIT_S)
    n_writers, n_writes = 2 * (os.cpu_count() or 4), 6
    acked = [[] for _ in range(n_writers)]
    errors = []

    def writer(i):
        try:
            for w in range(n_writes):
                ops = chain(100 + i, 3, start=3 * w + 1)
                ok, _ = eng.submit(f"c{i % 4}", body(ops))
                assert ok
                acked[i].extend(o.value for o in ops)
        except BaseException as e:   # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ths = [threading.Thread(target=writer, args=(i,), daemon=True)
               for i in range(n_writers)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(JOIN_S)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    try:
        assert not errors, errors
        assert eng.flush(JOIN_S)
        for d in range(4):
            vals = eng.get(f"c{d}").snapshot()
            pos = {v: k for k, v in enumerate(vals)}
            for i in range(d, n_writers, 4):
                got = [pos[v] for v in acked[i]]
                assert got == sorted(got) and len(got) == 3 * n_writes
            replica = tengine.init(999, device="cpu")
            replica.apply_wire(bytes(
                eng.get(f"c{d}").snapshot_view().ops_since_bytes(0)))
            assert replica.visible_values() == vals
    finally:
        eng.close()


def test_flush_then_close_stops_every_thread(tmp_path):
    eng = TEngine(device="cpu", flight=tflight.FlightRecorder(),
                  durable_dir=str(tmp_path / "d"), wal_sync="batch",
                  submit_timeout_s=SUBMIT_S)
    threads = [eng.scheduler, eng.sync_worker, eng.maintenance]
    assert all(t is not None and t.is_alive() for t in threads)
    for k in range(1, 30, 5):
        assert eng.submit("f", body(chain(1, 5, start=k)))[0]
    assert eng.flush(JOIN_S)
    eng.close(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)
    with pytest.raises(TStopped):
        eng.submit("f", body(chain(2, 1)))


# -- durability ------------------------------------------------------------

PKG = {"ref": (JEngine, jflight, JStopped), "port": (TEngine, tflight,
                                                       TStopped)}


def _engine(pkg, ddir, **kw):
    cls, flight, _ = PKG[pkg]
    kw.setdefault("oplog_hot_ops", 8)
    kw.setdefault("submit_timeout_s", 5.0)
    if pkg == "port":
        kw["device"] = "cpu"
    return cls(durable_dir=str(ddir), flight=flight.FlightRecorder(),
               **kw)


def _recovered(pkg, ddir):
    eng = _engine(pkg, ddir, wal_sync="commit")
    try:
        doc = eng.get("doc", create=False)
        assert doc is not None and doc.recovered
        snap = doc.read_view()
        return (tuple(snap.values), snap.state_fingerprint(),
                bytes(snap.ops_since_bytes(0)), doc.epoch)
    finally:
        eng.close()


def _crash_both(tmp_path, site, monkeypatch):
    """In each package: acked commits, then one commit killed at
    ``site`` (in-process: the scheduler dies like a SIGKILL).  The two
    doomed commits run at once, so their un-resolvable submits time out
    together.  Returns ``{pkg: every acked value}``."""
    monkeypatch.setenv("GRAFT_OPLOG_GC_SEGS", "1")
    monkeypatch.setenv("GRAFT_MATZ_TAIL_OPS", "8")
    ops = chain(1, 60)
    engs = {pkg: _engine(pkg, tmp_path / pkg, wal_sync="commit",
                         submit_timeout_s=2.0) for pkg in PKG}
    for eng in engs.values():
        for i in range(0, 20, 5):
            assert eng.submit("doc", body(ops[i:i + 5]))[0]
        assert eng.flush(JOIN_S)
    monkeypatch.setenv("GRAFT_CRASH_POINT", site)
    boxes = {pkg: {} for pkg in PKG}

    def doomed(pkg):
        try:
            boxes[pkg]["ack"] = engs[pkg].submit("doc", body(ops[20:40]))
        except PKG[pkg][2] as e:
            boxes[pkg]["err"] = e

    threads = [threading.Thread(target=doomed, args=(pkg,), daemon=True)
               for pkg in PKG]
    for th in threads:
        th.start()
    for pkg, eng in engs.items():
        eng.scheduler.join(JOIN_S)
        assert not eng.scheduler.is_alive(), \
            f"{pkg}/{site}: site never fired"
    for th in threads:
        th.join(JOIN_S)
        assert not th.is_alive()
    for eng in engs.values():
        # a kill takes every thread: when the site fired on the
        # scheduler, stop the maintenance lane too (it abandons its
        # queue), so no task of the dead engine writes under the
        # recovery below
        if eng.maintenance is not None:
            eng.maintenance.stop(timeout=JOIN_S)
            assert not eng.maintenance.is_alive()
    monkeypatch.delenv("GRAFT_CRASH_POINT")
    acked = {}
    for pkg in PKG:
        acked[pkg] = [o.value for o in ops[:20]]
        if boxes[pkg].get("ack", (False,))[0]:
            # the site fired after this commit's ack (a background
            # spill): its writes are acked and must survive too
            acked[pkg] += [o.value for o in ops[20:40]]
    return acked


@pytest.mark.parametrize("site", ["ack-pre-fsync",
                                  "post-fsync-pre-publish", "mid-spill"])
def test_commit_mode_crash_recovers_like_reference(tmp_path, site,
                                                   monkeypatch):
    """WAL sync ``commit``: a kill at each ack-boundary site loses no
    acked write; the port's recovered document equals the reference's
    recovery of the same workload, and each package recovers the
    other's crashed directory to the same state."""
    acked = _crash_both(tmp_path, site, monkeypatch)
    assert acked["ref"] == acked["port"]
    # cross-package: each directory recovered by the OTHER package
    # first (a recovery bumps the epoch, so it goes first), then by its
    # own writer
    cross = {"ref": _recovered("port", tmp_path / "ref"),
             "port": _recovered("ref", tmp_path / "port")}
    own = {"ref": _recovered("ref", tmp_path / "ref"),
           "port": _recovered("port", tmp_path / "port")}
    for pkg in ("ref", "port"):
        vals = set(own[pkg][0])
        assert not [v for v in acked[pkg] if v not in vals], \
            f"{pkg}/{site} lost acked writes"
        assert cross[pkg][:3] == own[pkg][:3]
        assert cross[pkg][3] == 2 and own[pkg][3] == 3
    assert own["ref"][:3] == own["port"][:3]


@pytest.mark.parametrize("backend", ["single", "workers", "uring"])
def test_sync_backends_recover_every_acked_write(tmp_path, backend):
    """Group commit (WAL sync ``batch``) on each fsync backend: every
    acked write of a two-document workload survives a restart, the
    backend ran is the one asked for, and the recovered documents equal
    the reference's recovery of the same workload."""
    if backend == "uring" and not turing.available():
        pytest.skip("the kernel lacks io_uring fsync support")
    states = {}
    for pkg in ("ref", "port"):
        ddir = tmp_path / pkg
        eng = _engine(pkg, ddir, wal_sync="batch",
                      wal_sync_backend=backend, submit_timeout_s=SUBMIT_S)
        assert eng.sync_worker.stats()["backend"] == backend
        for i in range(0, 20, 5):
            for rid, d in ((1, "docA"), (2, "docB")):
                assert eng.submit(d, body(chain(rid, 5, start=i + 1)))[0]
        assert eng.flush(JOIN_S)
        eng.close(timeout=JOIN_S)
        eng2 = _engine(pkg, ddir, wal_sync="commit")
        try:
            states[pkg] = {}
            for d in ("docA", "docB"):
                doc = eng2.get(d, create=False)
                assert doc is not None and doc.recovered
                snap = doc.read_view()
                assert len(snap.values) == 20
                states[pkg][d] = (tuple(snap.values),
                                  snap.state_fingerprint())
        finally:
            eng2.close()
    assert states["ref"] == states["port"]


@pytest.mark.parametrize("name,value", [
    ("GRAFT_READCACHE", "0"), ("GRAFT_SENDFILE", "0"),
    ("GRAFT_REACTOR", "0"), ("GRAFT_PIPELINE", "0")])
def test_non_default_switch_raises(monkeypatch, name, value):
    """The port keeps each of these switches at the reference's default:
    asking for the other path raises instead of being ignored, and the
    default spelled out is accepted."""
    monkeypatch.setenv(name, value)
    with pytest.raises(NotImplementedError, match=name):
        TEngine(device="cpu", start=False)
    monkeypatch.setenv(name, "0" if value == "1" else "1")
    TEngine(device="cpu", start=False).close()


def test_wal_shared_switch_arms_the_stream(tmp_path, monkeypatch):
    """``GRAFT_WAL_SHARED=1`` arms one shared stream on a durable
    engine (its writes land in ``wal-shared.log``, no per-doc
    ``wal.log``); ``0`` spelled out keeps a WAL a document."""
    monkeypatch.setenv("GRAFT_WAL_SHARED", "1")
    eng = _engine("port", tmp_path / "s", wal_sync="batch")
    try:
        assert isinstance(eng.shared_wal, twal.SharedWal)
        assert eng.sync_worker.stats()["backend"] == "single"
        assert eng.submit("doc", body(chain(1, 5)))[0]
        assert eng.flush(JOIN_S)
        assert isinstance(eng.get("doc").wal, twal.DocWalView)
        assert eng.shared_wal.telemetry()["appends"] == 1
    finally:
        eng.close()
    assert os.path.getsize(tmp_path / "s" / "wal-shared.log") > len(
        twal.SHARED_MAGIC)
    assert not (tmp_path / "s" / "doc-doc" / "wal.log").exists()
    monkeypatch.setenv("GRAFT_WAL_SHARED", "0")
    eng = _engine("port", tmp_path / "p", wal_sync="batch")
    try:
        assert eng.shared_wal is None
    finally:
        eng.close()


def test_shared_wal_dir_is_refused_not_dropped(tmp_path, monkeypatch):
    """A durable dir whose acked tail lives in the reference's shared
    WAL stream: the port replays it under ``GRAFT_WAL_SHARED=1`` (the
    same values, fingerprints and log as the reference's own recovery),
    and without the flag refuses it with a typed ``WalError`` rather
    than serving without those writes."""
    monkeypatch.setenv("GRAFT_WAL_SHARED", "1")
    eng = _engine("ref", tmp_path, wal_sync="commit")
    try:
        assert eng.submit("doc", body(chain(1, 5)))[0]
        assert eng.flush(JOIN_S)
    finally:
        eng.close()
    assert os.path.getsize(tmp_path / "wal-shared.log") > len(
        twal.SHARED_MAGIC)
    monkeypatch.delenv("GRAFT_WAL_SHARED")
    with pytest.raises(twal.WalError, match="shared WAL stream"):
        _engine("port", tmp_path, wal_sync="commit")
    monkeypatch.setenv("GRAFT_WAL_SHARED", "1")
    import shutil
    shutil.copytree(tmp_path, tmp_path.parent / (tmp_path.name + "-ref"))
    got = {"port": _recovered("port", tmp_path),
           "ref": _recovered("ref", tmp_path.parent / (tmp_path.name
                                                       + "-ref"))}
    assert got["port"] == got["ref"]
    assert [v for v in got["port"][0]] == [o.value for o in chain(1, 5)]


def test_prom_parses_and_unported_switches_raise(tmp_path, monkeypatch):
    eng = _engine("port", tmp_path / "d", wal_sync="batch")
    try:
        assert eng.submit("doc", body(chain(1, 5)))[0]
        assert eng.flush(JOIN_S)
        fams = tprom.parse_text(eng.render_prom())
        assert "crdt_doc_ops_merged_total" in fams
        assert "crdt_wal_sync_backend" in fams
        assert "crdt_span_count_total" in fams or any(
            f.startswith("crdt_span") for f in fams)
    finally:
        eng.close()
    # the merge tier is ported: a worker list arms a client; the env
    # switch with no worker named stays local, as in the reference
    eng = TEngine(device="cpu", mergetier=["127.0.0.1:1"], start=False)
    try:
        assert eng.mergetier is not None
        assert eng.mergetier.workers[0].endpoint == "127.0.0.1:1"
    finally:
        eng.close()
    monkeypatch.setenv("GRAFT_MERGETIER", "1")
    monkeypatch.delenv("GRAFT_MERGETIER_WORKERS", raising=False)
    eng = TEngine(device="cpu", start=False)
    try:
        assert eng.mergetier is None
    finally:
        eng.close()
    monkeypatch.delenv("GRAFT_MERGETIER")
    # the host-shared body cache is ported: the switch arms one, in a
    # namespace of this test's own
    monkeypatch.setenv("GRAFT_SHMCACHE", "1")
    monkeypatch.setenv("GRAFT_SHMCACHE_NS", f"t{os.getpid()}x{id(eng)}")
    eng = TEngine(device="cpu", start=False)
    try:
        assert eng.shmcache is not None
        assert eng.shmcache.namespace == os.environ["GRAFT_SHMCACHE_NS"]
    finally:
        eng.close()
    monkeypatch.delenv("GRAFT_SHMCACHE")
    # the chain-audit sampler is ported: a positive period arms it
    monkeypatch.setenv("GRAFT_OBS_AUDIT_EVERY", "64")
    assert tflight.FlightRecorder().audit_every == 64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TEngine(start=False)
