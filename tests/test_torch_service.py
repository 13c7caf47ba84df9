"""The port's HTTP wire service against the reference's, on the CPU.

Both servers run on 127.0.0.1 port 0: the reference's ``make_server``
over its ``ServingEngine`` and the port's over ``ServingEngine(device=
"cpu")``.  One scripted single-client session — replica ids, small and
>1 MB (native-parsed) ``POST /ops``, ``GET /ops?since=`` with and
without windows, conditional reads, snapshot, clock, metrics and every
error status (400, 404, 409, 413, 429) — goes to both; they must agree
on the status, the body and the ``ETag``, ``X-Since-*``,
``X-Commit-Seq``, ``X-Snapshot-Fingerprint``, ``Retry-After``,
``X-Watch-*`` and ``Content-Type`` headers (metrics bodies: their keys
and counters, the timings differ by nature).  Long-poll and SSE
``/watch`` rounds — a resume, a timeout, a parked watcher woken by a
write, a stream delivered by the reactor, a close on shutdown — are
held to the reference byte for byte.  ``/metrics/prom`` parses under the strict
contract, ``/debug/flight`` carries every pushed trace id, and the Elm
interop fixtures of ``tests/test_elm_interop.py`` replay through the
port's server.

Every request carries its own socket timeout, and every server thread
is joined with one.
"""
import json
import threading
import time
import types
import zipfile
from http.client import HTTPConnection

import pytest

import jax

jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

torch.set_num_threads(1)

from crdt_graph_tpu import Add  # noqa: E402
from crdt_graph_tpu.codec import json_codec as jjson  # noqa: E402
from crdt_graph_tpu.core.operation import Batch  # noqa: E402
from crdt_graph_tpu.obs import flight as jflight  # noqa: E402
from crdt_graph_tpu.serve import ServingEngine as JEngine  # noqa: E402
from crdt_graph_tpu.service import make_server as jmake  # noqa: E402

from crdt_graph_tpu_torch.obs import flight as tflight  # noqa: E402
from crdt_graph_tpu_torch.obs import prom as tprom  # noqa: E402
from crdt_graph_tpu_torch.serve import ServingEngine as TEngine  # noqa: E402
from crdt_graph_tpu_torch.service import make_server as tmake  # noqa: E402
from crdt_graph_tpu_torch.service import DocumentStore  # noqa: E402

import test_elm_interop as elm  # noqa: E402

OFF = 2**32
REQ_S = 60           # every request's socket timeout
SESSION = "sess-0123456789"
COMPARED = ("ETag", "X-Since-Found", "X-Since-More", "X-Since-Next",
            "X-Commit-Seq", "X-Snapshot-Fingerprint", "Retry-After",
            "Content-Type", "X-Trace-Id", "X-Session-Id",
            "X-Watch-Event", "X-Watch-Resume-Since")
PARK_S = 30          # how long a test waits for a watcher to park


@pytest.fixture(autouse=True)
def _serving_env(monkeypatch):
    monkeypatch.setenv("GRAFT_OBS_AUDIT_EVERY", "0")
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: 1_700_000_000.0, localtime=time.localtime))


class Served:
    """A server on port 0 in a thread, over an engine it closes."""

    def __init__(self, make, engine, **kw):
        self.engine = engine
        self.srv = make(port=0, store=engine, **kw)
        self.th = threading.Thread(target=self.srv.serve_forever,
                                   daemon=True)
        self.th.start()

    def request(self, method, path, body=None, headers=None, raw=None):
        conn = HTTPConnection("127.0.0.1", self.srv.server_port,
                              timeout=REQ_S)
        try:
            if raw is not None:
                conn.putrequest(method, path)
                for k, v in raw.items():
                    conn.putheader(k, v)
                conn.endheaders()
            else:
                conn.request(method, path, body=body,
                             headers=headers or {})
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, data, {k: resp.getheader(k)
                                       for k in COMPARED}
        finally:
            conn.close()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.engine.close()
        self.th.join(REQ_S)
        assert not self.th.is_alive()


def _engines(**kw):
    kw.setdefault("submit_timeout_s", 60.0)
    return (JEngine(flight=jflight.FlightRecorder(), **kw),
            TEngine(flight=tflight.FlightRecorder(), device="cpu", **kw))


@pytest.fixture()
def pair():
    je, te = _engines()
    servers = (Served(jmake, je, max_body=4 << 20),
               Served(tmake, te, max_body=4 << 20))
    yield servers
    for s in servers:
        s.close()


def chain(rid, n, start=1):
    ops, prev = [], (rid * OFF + start - 1 if start > 1 else 0)
    for c in range(start, start + n):
        ops.append(Add(rid * OFF + c, (prev,), f"v{rid}.{c}"))
        prev = rid * OFF + c
    return ops


_N_TRACE = [0]


def _same(pair, method, path, body=None, headers=None, raw=None,
          json_keys=None):
    """Send one request to both servers; statuses, headers and bodies
    must agree (``json_keys``: compare only those keys of a JSON body,
    and the key sets).  Each request names its trace id, so the ids
    the two servers echo agree."""
    _N_TRACE[0] += 1
    headers = {"X-Trace-Id": f"{_N_TRACE[0]:016x}", **(headers or {})}
    (js, jb, jh), (ts, tb, th) = (
        s.request(method, path, body=body, headers=headers, raw=raw)
        for s in pair)
    assert js == ts, (method, path, jb, tb)
    assert jh == th, (method, path)
    if json_keys is None:
        assert jb == tb, (method, path)
    else:
        ja, ta = json.loads(jb), json.loads(tb)
        assert sorted(ja) == sorted(ta)
        for k in json_keys(ja):
            assert ja[k] == ta[k], (path, k)
    return ts, tb, th


def _post(pair, doc, payload, status=200):
    st, b, h = _same(pair, "POST", f"/docs/{doc}/ops", body=payload,
                     headers={"X-Session-Id": SESSION})
    assert st == status, b
    return h["X-Trace-Id"], json.loads(b)


def _doc_counters(m):
    return [k for k in m if k not in ("commit_latency_ms",
                                      "coalesce_width", "snapshot_age_s",
                                      "oplog", "readcache", "watch")]


def test_scripted_session_is_byte_identical(pair):
    hdr = {"X-Session-Id": SESSION}
    st, b, _ = _same(pair, "POST", "/docs/d/replicas")
    assert json.loads(b) == {"replica": 1}
    _same(pair, "POST", "/docs/d/replicas")
    tids = []
    tid, out = _post(pair, "d", jjson.dumps(Batch(tuple(chain(1, 5)))))
    assert out["applied_count"] == 5 and "applied" in out
    tids.append(tid)
    big = jjson.dumps(Batch(tuple(chain(2, 20000))))
    assert len(big) > 1 << 20                 # the native parse route
    tid, out = _post(pair, "d", big)
    assert out["applied_count"] == 20000 and "applied" not in out
    tids.append(tid)
    tid, out = _post(pair, "d", jjson.dumps(Add(2 * OFF + 20001,
                                                (2 * OFF + 20000,), "z")))
    tids.append(tid)
    tid, out = _post(pair, "d", jjson.dumps(Batch(tuple(chain(1, 5)))))
    assert out["applied_count"] == 0          # duplicate, absorbed
    tids.append(tid)
    tid, out = _post(pair, "d", jjson.dumps(Add(7 * OFF + 1, (4321,), "x")),
                     status=409)
    assert not out["accepted"]
    tids.append(tid)

    st, _, h = _same(pair, "GET", "/docs/d", headers=hdr)
    assert st == 200 and h["ETag"] and h["X-Commit-Seq"] == "3"
    st, b, _ = _same(pair, "GET", "/docs/d",
                     headers={"If-None-Match": h["ETag"], **hdr})
    assert st == 304 and b == b""
    st, full, _ = _same(pair, "GET", "/docs/d/ops?since=0")
    assert st == 200 and len(full) > 1 << 20
    since = 2 * OFF + 19990
    st, _, h = _same(pair, "GET", f"/docs/d/ops?since={since}&limit=4")
    assert h["X-Since-More"] == "1" and h["X-Since-Next"]
    _same(pair, "GET", f"/docs/d/ops?since={since}&limit=4",
          headers={"If-None-Match": h["ETag"]})
    _same(pair, "GET", f"/docs/d/ops?since={h['X-Since-Next']}&limit=100")
    _same(pair, "GET", "/docs/d/ops?since=99999&limit=3")
    st, snap, h = _same(pair, "GET", "/docs/d/snapshot", headers=hdr)
    assert st == 200 and h["Content-Type"] == "application/octet-stream"
    _same(pair, "GET", "/docs/d/snapshot",
          headers={"If-None-Match": h["ETag"], **hdr})
    _same(pair, "GET", "/docs/d/clock")
    _same(pair, "GET", "/docs/d/metrics", json_keys=_doc_counters)
    _same(pair, "GET", "/docs", )
    _same(pair, "GET", "/metrics",
          json_keys=lambda m: [])
    _same(pair, "GET", "/metrics/scheduler", json_keys=lambda m: [
        k for k in ("docs", "queue_depth_total", "mergetier",
                    "cross_doc_batches") if k in m])

    # every error status the single-client path can meet
    assert _same(pair, "POST", "/docs/d/ops", body=b"{not json")[0] == 400
    assert _same(pair, "POST", "/docs/d/ops",
                 body=b'{"op":"add","path":[0]}')[0] == 400
    assert _same(pair, "GET", "/docs/d/ops?since=abc")[0] == 400
    assert _same(pair, "POST", "/docs/d/ops",
                 raw={"Content-Length": "12x"})[0] == 400
    assert _same(pair, "POST", "/docs/d/ops",
                 raw={"Content-Length": str(8 << 20)})[0] == 413
    assert _same(pair, "GET", "/docs/nope")[0] == 404
    assert _same(pair, "GET", "/docs/d/nope")[0] == 404
    assert _same(pair, "GET", "/nope")[0] == 404
    assert _same(pair, "POST", "/docs/d/nope", body=b"{}")[0] == 404

    # the port's own surfaces
    port = pair[1]
    assert port.engine.flush(60)
    st, text, _ = port.request("GET", "/metrics/prom")
    assert st == 200
    fams = tprom.parse_text(text.decode())
    assert "crdt_doc_ops_merged_total" in fams
    st, fl, _ = port.request("GET", "/debug/flight")
    recs = json.loads(fl)["records"]
    seen = {t for r in recs for t in r["trace_ids"]}
    assert set(tids) <= seen
    assert all(r["audit"] is None for r in recs)


def _parked(pair, doc, n=1):
    """Wait until ``n`` watchers of ``doc`` are parked on each server's
    reactor."""
    deadline = time.monotonic() + PARK_S
    while time.monotonic() < deadline:
        if all(s.engine.get(doc).watch.counts()["parked"] >= n
               for s in pair):
            return
        time.sleep(0.01)
    raise AssertionError(f"no watcher of {doc!r} parked")


def _released(pair, doc):
    """Wait until every watch slot of ``doc`` is released on each
    server: a handler (or the reactor, for a parked watcher) releases
    its slot after the response is sent, so a client can read the
    response first."""
    deadline = time.monotonic() + PARK_S
    while time.monotonic() < deadline:
        if all(s.engine.get(doc).watch.counts()["registered"] == 0
               for s in pair):
            return
        time.sleep(0.01)
    raise AssertionError(f"a watch slot of {doc!r} was never released")


def _watch_both(pair, path, trace):
    """Start one watch request on each server, each in its own thread;
    returns a function that joins them and gives both results."""
    out, ths = [None, None], []
    for i, srv in enumerate(pair):
        def run(i=i, srv=srv):
            out[i] = srv.request("GET", path, headers={
                "X-Trace-Id": trace, "X-Session-Id": SESSION})
        ths.append(threading.Thread(target=run, daemon=True))
        ths[-1].start()

    def join():
        for th in ths:
            th.join(REQ_S)
            assert not th.is_alive()
        return out
    return join


def _same_results(results):
    (js, jb, jh), (ts, tb, th) = results
    assert js == ts and jh == th and jb == tb, (js, ts, jb, tb)
    return ts, tb, th


@pytest.fixture()
def watch_pair(monkeypatch):
    """Servers whose SSE heartbeat never falls inside a test's stream,
    so a stream's bytes do not depend on timing."""
    monkeypatch.setenv("GRAFT_WATCH_HEARTBEAT_S", "600")
    je, te = _engines()
    servers = (Served(jmake, je), Served(tmake, te))
    yield servers
    for s in servers:
        s.close()


def test_watch_long_poll_is_byte_identical(watch_pair):
    """Long-poll ``/watch`` rounds: a resume (ops waiting), a timeout
    with no write (at once, and after parking on the reactor), a parked
    watcher woken by a write, and a first poll whose ``If-None-Match``
    is stale — statuses, bodies and headers equal the reference's."""
    pair = watch_pair
    _post(pair, "w", jjson.dumps(Batch(tuple(chain(1, 5)))))
    st, b, h = _same(pair, "GET", "/docs/w/watch?since=0",
                     headers={"X-Session-Id": SESSION})
    assert st == 200 and h["X-Watch-Event"] == "resume"
    mark = h["X-Since-Next"]
    for wait in ("0", "0.2"):
        st, b, h = _same(pair, "GET",
                         f"/docs/w/watch?since={mark}&timeout={wait}",
                         headers={"X-Session-Id": SESSION})
        assert h["X-Watch-Event"] == "timeout"
        assert b == b'{"op":"batch","ops":[]}'
    caught_up = h["ETag"]
    join = _watch_both(pair, f"/docs/w/watch?since={mark}&timeout=30",
                       "watch-notify-0001")
    _parked(pair, "w")
    _post(pair, "w", jjson.dumps(Batch(tuple(chain(1, 3, start=6)))))
    st, b, h = _same_results(join())
    assert st == 200 and h["X-Watch-Event"] == "notify"
    assert h["X-Since-Next"] != mark and b"v1.8" in b
    # a first poll whose validator predates the write delivers at once
    st, b, h = _same(pair, "GET", f"/docs/w/watch?since={h['X-Since-Next']}",
                     headers={"If-None-Match": caught_up,
                              "X-Session-Id": SESSION})
    assert h["X-Watch-Event"] == "resume"
    _released(pair, "w")


def test_watch_sse_stream_is_byte_identical(watch_pair):
    """An SSE ``/watch`` stream: the events already due, a generation
    delivered by the reactor while the stream is parked, and the named
    goodbye at the stream's budget — the same bytes as the
    reference's."""
    pair = watch_pair
    _post(pair, "e", jjson.dumps(Batch(tuple(chain(2, 4)))))
    join = _watch_both(pair, "/docs/e/watch?since=0&mode=sse&timeout=3",
                       "watch-sse-000001")
    _parked(pair, "e")
    _post(pair, "e", jjson.dumps(Batch(tuple(chain(2, 2, start=5)))))
    st, b, h = _same_results(join())
    assert st == 200 and h["Content-Type"] == "text/event-stream"
    events = b.split(b"\n\n")
    assert [e.split(b"\n")[0] for e in events if e] == [
        b"event: ops", b"event: ops", b"event: bye"]
    assert b"v2.6" in events[1] and b"v2.1" not in events[1]


def test_watch_closed_on_shutdown_is_identical():
    """A watcher parked on the reactor when its engine closes gets the
    named 503 close from both servers."""
    je, te = _engines()
    pair = (Served(jmake, je), Served(tmake, te))
    try:
        _post(pair, "c", jjson.dumps(Batch(tuple(chain(3, 2)))))
        _, _, h = _same(pair, "GET", "/docs/c/watch?since=0",
                        headers={"X-Session-Id": SESSION})
        join = _watch_both(
            pair, f"/docs/c/watch?since={h['X-Since-Next']}&timeout=30",
            "watch-close-00001")
        _parked(pair, "c")
    finally:
        for s in pair:
            s.close()
    st, b, h = _same_results(join())
    assert st == 503 and h["X-Watch-Event"] == "closed"


def test_full_queue_429_is_identical():
    je, te = _engines(start=False, max_queue_requests=0)
    pair = (Served(jmake, je), Served(tmake, te))
    try:
        st, b, h = _same(pair, "POST", "/docs/busy/ops",
                         body=jjson.dumps(Batch(tuple(chain(1, 3)))),
                         headers={"X-Trace-Id": "busy-0000000001"})
        assert st == 429 and int(h["Retry-After"]) >= 1
        assert json.loads(b)["trace_id"] == "busy-0000000001"
    finally:
        for s in pair:
            s.close()


@pytest.mark.parametrize("name", sorted(
    n for n in dir(elm) if n.startswith("test_") and "server" in
    getattr(elm, n).__code__.co_varnames[
        :getattr(elm, n).__code__.co_argcount]))
def test_elm_fixtures_replay_through_port(name):
    """Each Elm interop test of ``tests/test_elm_interop.py``, run
    against the port's server (the same fixtures and assertions)."""
    srv = Served(tmake, TEngine(device="cpu",
                                flight=tflight.FlightRecorder(),
                                submit_timeout_s=60.0))
    try:
        def req(s, method, path, body=None):
            st, data, _ = s.request(method, path, body=body)
            return st, json.loads(data.decode())
        getattr(elm, name)(srv, req)
    finally:
        srv.close()


def test_legacy_document_store_serves_identically():
    """``make_server(store=DocumentStore(device="cpu"))``: the inline
    merge path answers a session like the serving engine."""
    from crdt_graph_tpu.service import DocumentStore as JStore
    pair = (Served(jmake, JStore()), Served(tmake,
                                           DocumentStore(device="cpu")))
    pair[0].engine.close = pair[1].engine.close = lambda: None
    try:
        _same(pair, "POST", "/docs/s/replicas")
        _post(pair, "s", jjson.dumps(Batch(tuple(chain(1, 1500)))))
        _post(pair, "s", jjson.dumps(Batch(tuple(chain(1, 4,
                                                       start=1501)))))
        _same(pair, "GET", "/docs/s")
        _same(pair, "GET", "/docs/s/ops?since=0")
        _same(pair, "GET", "/docs/s/clock")
        _same(pair, "GET", "/docs/s/metrics")
    finally:
        for s in pair:
            s.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DocumentStore()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmake(port=0)
