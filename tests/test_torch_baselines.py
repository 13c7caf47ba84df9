"""The serving stack's three A/B baselines, brought back in the port as
``ServingEngine`` arguments only: ``readcache=False`` (every read
re-encodes its body), ``sendfile=False`` (cold ``/ops`` windows take the
buffered load→encode path) and ``reactor=False`` (a parked watcher
holds its handler thread).  The reference's own tests of them run again
with their module names pointed at the port (``tests/_torch_replay.py``),
or, where the reference switches by environment, as the same test with
the engine argument: each side serves byte-identical bodies, ETags and
``X-Since-*`` headers.  The environment switches ``GRAFT_READCACHE=0``,
``GRAFT_SENDFILE=0`` and ``GRAFT_REACTOR=0`` still raise
(``test_torch_serve.py``)."""
import functools
import json
import socket
import threading

import pytest

import test_reactor as ref_reactor  # noqa: E402 — configures JAX for the CPU
import test_readpath as ref_readpath  # noqa: E402
import test_sendfile as ref_sendfile  # noqa: E402
import _torch_replay  # noqa: E402

from crdt_graph_tpu_torch.cluster.pool import ConnectionPool
from crdt_graph_tpu_torch.codec import json_codec as tjson
from crdt_graph_tpu_torch.core.operation import Add, Batch
from crdt_graph_tpu_torch.obs import prom as tprom
from crdt_graph_tpu_torch.codec.packed import EMPTY_BATCH_BYTES
from crdt_graph_tpu_torch.serve import ServingEngine
from crdt_graph_tpu_torch.service import make_server

PORT_ENGINE = functools.partial(ServingEngine, device="cpu")
NAMES = (("ServingEngine", PORT_ENGINE), ("json_codec", tjson),
         ("Add", Add), ("Batch", Batch))
REACTOR_NAMES = NAMES + (("make_server", make_server),
                         ("ConnectionPool", ConnectionPool),
                         ("prom_mod", tprom),
                         ("EMPTY_BATCH_BYTES", EMPTY_BATCH_BYTES))


def test_readcache_off_serves_identical_bytes_on_port(tmp_path,
                                                      monkeypatch):
    """``tests/test_readpath.py``'s cache on/off test on the port's
    engine: values, clock, window and full-log bodies and the ETag are
    byte-identical, and the uncached side never hits."""
    _torch_replay.run(ref_readpath, "test_cache_on_off_bodies_byte_identical",
                      None, tmp_path, monkeypatch, names=NAMES)


@pytest.mark.parametrize("name", [
    "test_reactor_ab_poll_byte_identity_across_seams",
    "test_reactor_ab_sse_frames_identical",
    "test_reactor_prom_families_present_and_gated"])
def test_reactor_off_test_passes_on_port(name, tmp_path, monkeypatch):
    """``tests/test_reactor.py``'s tests that run ``reactor=False`` beside
    the reactor: every long-poll delivery class (resume across tier
    seams, notify, timeout heartbeat, shed) and the SSE frames are
    byte-identical between the two park paths; the reactor's prom
    families appear only with it."""
    _torch_replay.run(ref_reactor, name, None, tmp_path, monkeypatch,
                      names=REACTOR_NAMES)


def _fill(eng, doc="d", rounds=30):
    """``tests/test_sendfile.py``'s fill, through the port's codec:
    enough sealed cold segments for several all-cold windows."""
    anchor = 0
    for i in range(rounds):
        ops, anchor = ref_sendfile._chain_round(i, anchor)
        wire = tjson.dumps(Batch(tuple(
            Add(o.ts, tuple(o.path), o.value) for o in ops)))
        ok, _ = eng.submit(doc, wire)
        assert ok, i


def test_sendfile_off_baseline_identical_on_port():
    """``tests/test_sendfile.py::test_sendfile_off_baseline_identical`` on
    the port, with ``sendfile=False`` for ``GRAFT_SENDFILE=0``: no stats
    object, no plan consulted, and the buffered window byte-identical to
    the one the zero-copy path served — and to the reference engine's
    buffered window of the same ops."""
    eng = ServingEngine(oplog_hot_ops=8, device="cpu")
    assert eng.sendfile_stats is not None, "sendfile default-on"
    _fill(eng)
    srv = make_server(port=0, store=eng)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    pool = ConnectionPool()

    def get(path, headers=None):
        resp, body = pool.request("t", "server", "127.0.0.1", port, "GET",
                                  path, headers=headers or {})
        return resp.status, body, {k.lower(): v
                                   for k, v in resp.getheaders()}

    eng2 = None
    try:
        (b0, h0), (b1, h1) = ref_sendfile._await_sendfile(
            eng, get, "/docs/d/ops?since=0&limit=16")
        assert b1 == b0 and h1["etag"] == h0["etag"]
        eng2 = ServingEngine(oplog_hot_ops=8, sendfile=False, device="cpu")
        assert eng2.sendfile_stats is None
        _fill(eng2)
        doc2 = eng2.get("d")
        assert doc2.ops_window_plan(0, 16) is None
        b2, _m2 = doc2.ops_since_window(0, 16)
        assert b2 == b0, "baseline engine bytes differ"
        ref = ref_sendfile.ServingEngine(oplog_hot_ops=8)
        try:
            ref_sendfile._fill(ref)
            b3, _m3 = ref.get("d").ops_since_window(0, 16)
        finally:
            ref.close()
        assert b3 == b0, "port bytes differ from the reference's"
    finally:
        pool.close()
        srv.shutdown()
        srv.server_close()
        eng.close()
        if eng2 is not None:
            eng2.close()


def _chain(rid, n, start=1, prev=0):
    ops = []
    for c in range(start, start + n):
        ops.append(Add(rid * 2**32 + c, (prev,), f"r{rid}:{c}"))
        prev = rid * 2**32 + c
    return tjson.dumps(Batch(tuple(ops)))


def test_readcache_off_reports_disabled_everywhere():
    """The uncached engine says so: the read cache's snapshot, the
    ``crdt_readcache_enabled`` gauge, and no shm tier even when asked."""
    eng = ServingEngine(readcache=False, shmcache=True, device="cpu")
    try:
        doc = eng.get("d")
        assert doc.apply_body(_chain(1, 5))[0]
        snap = doc.read_view()
        first = snap.values_body()
        assert snap.values_body() == first
        rc = doc.readcache.snapshot()
        assert rc["enabled"] is False
        assert (rc["hits"], rc["misses"]) == (0, 2)
        assert eng.shmcache is None
        fams = tprom.parse_text(tprom.render_engine(eng))
        assert fams["crdt_readcache_enabled"]["samples"][0][2] == 0.0
    finally:
        eng.close()


def test_reactor_that_fails_to_build_raises(monkeypatch):
    """An engine asked for the reactor never falls back to parking on
    handler threads: the reactor's construction error propagates."""
    from crdt_graph_tpu_torch.serve import reactor as reactor_mod

    def broken(**kw):
        raise OSError("no selector")
    monkeypatch.setattr(reactor_mod, "Reactor", broken)
    with pytest.raises(OSError, match="no selector"):
        ServingEngine(device="cpu", start=False)


def test_threaded_park_shutdown_writes_named_closes():
    """``reactor=False``: parked long polls hold handler threads on the
    registry, and ``engine.close()`` wakes each with the same named
    closes the reactor writes (503 ``X-Watch-Event: closed``, SSE
    ``event: closed``)."""
    eng = ServingEngine(reactor=False, device="cpu")
    assert eng.reactor is None
    srv = make_server(port=0, store=eng)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    pool = ConnectionPool()
    try:
        resp, raw = pool.request("t", "server", "127.0.0.1",
                                 srv.server_port, "POST", "/docs/d/ops",
                                 body=_chain(1, 3))
        assert resp.status == 200 and json.loads(raw)["accepted"]
        resp, _ = pool.request("t", "server", "127.0.0.1",
                               srv.server_port, "GET",
                               "/docs/d/ops?since=0&limit=100")
        mark = int(resp.getheader("X-Since-Next"))
        socks = []
        for extra in ("", "", "&mode=sse"):
            s = socket.create_connection(("127.0.0.1", srv.server_port),
                                         timeout=10)
            s.sendall((f"GET /docs/d/watch?since={mark}&limit=100"
                       f"&timeout=30{extra} HTTP/1.1\r\nHost: t\r\n\r\n"
                       ).encode())
            socks.append(s)
        ref_reactor._wait_parked(eng.get("d"), n=3)
        eng.close()
        for s in socks[:2]:
            head, body = ref_reactor._read_http(s)
            assert b"HTTP/1.1 503" in head
            assert b"X-Watch-Event: closed" in head
            assert json.loads(body) == {"error": "engine shutting down"}
        raw = b""
        socks[2].settimeout(10)
        while True:
            c = socks[2].recv(65536)
            if not c:
                break
            raw += c
        assert b"event: closed\ndata: {}\n\n" in raw
    finally:
        for s in socks:
            s.close()
        pool.close()
        srv.shutdown()
        srv.server_close()
        eng.close()
