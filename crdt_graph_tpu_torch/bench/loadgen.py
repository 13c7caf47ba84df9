"""Closed-loop session load harness: drive the real HTTP surface with
concurrent sessions and CHECK the session guarantees online.

Unlike :mod:`~crdt_graph_tpu_torch.bench.serving` (in-process, no checker),
this harness is the serving layer's *verifier*: N closed-loop sessions
talk to a real ``service.http`` server over sockets, every request
stamped with session + trace ids, and the observed stream — write-ack
trace echoes, read-path ``X-Commit-Seq``/``X-Snapshot-Fingerprint``
headers, and the flight recorder's commit records (consumed via the
in-process listener feed) — flows into a
:class:`~crdt_graph_tpu_torch.obs.oracle.SessionOracle` that checks
read-your-writes, monotonic reads, dropped acks, and convergence as
the load runs.  The run's headline (sustained merged ops/sec + reader
p50/p99 under load + violation count) is the serving counterpart of
the kernel bench headline.  Every engine the harness builds itself
merges on ``LoadgenConfig.device`` (the card unless it names another;
it raises without one); an engine the caller passes keeps its own.

Traffic shapes (mixed per run, assigned per session):

- **editor replay** (bench config 1's flavor): append-mostly deltas
  with occasional backspaces, a read after every acked write;
- **write bursts** — back-to-back writes with no interleaved read, so
  concurrent sessions' deltas pile into the scheduler's coalesced
  commits (the first round is STAGED under a paused scheduler, so at
  least one genuinely multi-writer commit is guaranteed, not
  probabilistic);
- **shed-and-read** — a small admission queue turns bursts into 429s;
  a shed session issues reads while it backs off (reads must stay
  monotone THROUGH shedding);
- **giant-merge racer** — one session pushes a chunk-spanning delta
  while everyone else's reads race the chunked merge.

Usage: ``python -m crdt_graph_tpu_torch.bench.loadgen [--device cpu]
[--fleet] [sessions] [writes]``.
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import random
import re
import selectors
import socket
import threading
import time
from http.client import HTTPConnection, HTTPException
from typing import Any, Dict, List, Optional

from ..codec import json_codec
from ..core.operation import Add, Batch, Delete
from ..obs import oracle as oracle_mod
from ..obs import prom as prom_mod
from ..obs.trace import (COMMIT_SEQ_HEADER, SESSION_HEADER,
                         SINCE_NEXT_HEADER, SNAP_FP_HEADER,
                         TRACE_HEADER, WATCH_EVENT_HEADER)
from ..serve import ServingEngine

OFFSET = 2**32


@dataclasses.dataclass
class LoadgenConfig:
    """One closed-loop run.  Defaults are smoke-sized; a headline run
    scales sessions into the hundreds and total leaves past 50k."""
    n_sessions: int = 12
    n_docs: int = 3
    writes_per_session: int = 6
    delta_size: int = 10
    backspace_p: float = 0.15      # editor-replay flavor (config 1)
    burst_fraction: float = 0.5    # sessions that burst (no read between)
    reads_per_write: int = 1       # >1 = the read-heavy shape (pollers
    #                                re-reading a growing doc dominate
    #                                the wall)
    max_queue_requests: int = 64   # small → 429 shedding is exercised
    giant_ops: int = 0             # 0 = no giant-merge racer
    stage_first_round: bool = True
    read_timeout_s: float = 120.0
    seed: int = 0
    # -- fleet mode (run_fleet) ------------------------------------------
    n_servers: int = 1             # >1 = in-process replica fleet
    lease_ttl_s: float = 3.0
    ae_interval_s: float = 0.1
    delta_cap: int = 8192          # anti-entropy window cap (leaves)
    kill_mid_run: bool = False     # crash the giant's primary mid-merge
    restart_killed: bool = True    # then rejoin it under the same name
    lag_probe_every: int = 4       # every Nth acked write measures
    #                                ack→visible-on-another-replica lag
    spray_read_p: float = 0.5      # extra read via a random replica
    # deterministic network fault injection (cluster/netchaos.py) on
    # the fleet's INTER-NODE links — anti-entropy pulls + write
    # forwarding.  Seeded by cfg.seed; the report carries the fired
    # counters and the replay line.
    netchaos_spec: Optional[str] = None
    # ALSO run the session/giant client links through the plan (links
    # named by session id, targetable by part= groups).  The harness'
    # own quiesce/verification requests always stay clean so the
    # convergence checks measure the fleet, not the harness' luck.
    netchaos_clients: bool = False
    # -- watch fan-out mode ----------------------------------------------
    # long-poll watchers chasing the publish pointer via /watch while
    # the write load runs: every delivery is oracle-observed (a
    # watcher is a read session — monotonic reads must hold through
    # notify/resume/shed), and report["watch"] carries both the
    # client-side delivery counts and the server registries' stats
    n_watchers: int = 0
    watch_limit: int = 8192        # shared window cap: caught-up
    #                                watchers ask the SAME (since,
    #                                limit) → one encode per generation
    watch_timeout_s: float = 2.0   # per-request park budget (also
    #                                bounds harness teardown)
    # watcher transport: a thread per watcher caps the
    # CLIENT at ~1k sessions — the selector driver runs the whole
    # population as raw keep-alive sockets on ONE thread, which is
    # what lets the harness actually offer the 10k+ populations the
    # reactor parks.  None = auto (selector from 64 watchers up);
    # delivery semantics, counters, and oracle checks are identical.
    watch_selector: Optional[bool] = None
    # the device of every engine the harness builds itself (None = the
    # card; it raises without one); an engine passed to run() keeps
    # its own
    device: Optional[str] = None


class _Session(threading.Thread):
    """One closed-loop session: its own HTTP connection, replica id,
    causally valid op chain, and oracle reporting."""

    def __init__(self, harness: "_Harness", idx: int):
        super().__init__(name=f"loadgen-s{idx}", daemon=True)
        self.h = harness
        self.idx = idx
        cfg = harness.cfg
        self.sid = f"sess-{idx:04d}"
        self.doc = f"load{idx % cfg.n_docs}"
        self.burst = (idx % cfg.n_docs != 0 and
                      random.Random(cfg.seed * 7919 + idx).random()
                      < cfg.burst_fraction)
        self.rng = random.Random(cfg.seed * 104729 + idx)
        self.rid: Optional[int] = None
        self.counter = 0
        self.alive: List[int] = []     # own visible timestamps, in order
        self.writes_acked = 0
        self.leaves_acked = 0
        self.shed_429 = 0
        self.read_ms: List[float] = []
        # per-acked-write latency of the SUCCESSFUL attempt (parse +
        # queue + merge + WAL append/fsync + publish): the number the
        # WAL headline bench prices the durability tax with
        self.ack_ms: List[float] = []
        self.errors: List[str] = []

    # -- transport --------------------------------------------------------

    def _request(self, method: str, path: str, body=None, headers=None):
        """One pooled keep-alive request (cluster/pool.py): the link
        is ``(session, server)``, so reuse happens per session and the
        report's pool counters prove persistent connections carried
        the run."""
        return self.h.pool.request(
            self.sid, "server", "127.0.0.1", self.h.port,
            method, path, body=body, headers=headers,
            timeout=self.h.cfg.read_timeout_s)

    # -- traffic ----------------------------------------------------------

    def _delta(self, size: int) -> Batch:
        """Editor-replay-shaped causally valid delta: appends at the
        caret (own chain), occasional backspaces of own chars."""
        ops = []
        for _ in range(size):
            if self.alive and self.rng.random() < self.h.cfg.backspace_p:
                ops.append(Delete((self.alive.pop(),)))
            else:
                self.counter += 1
                ts = self.rid * OFFSET + self.counter
                anchor = self.alive[-1] if self.alive else 0
                ops.append(Add(ts, (anchor,),
                               chr(97 + self.counter % 26)))
                self.alive.append(ts)
        return Batch(tuple(ops))

    def _read(self, final: bool = False) -> bool:
        t0 = time.perf_counter()
        resp, raw = self._request(
            "GET", f"/docs/{self.doc}",
            headers={SESSION_HEADER: self.sid})
        ms = (time.perf_counter() - t0) * 1e3
        if resp.status != 200:
            self.errors.append(f"read -> {resp.status}")
            return False
        self.read_ms.append(ms)
        seq = resp.getheader(COMMIT_SEQ_HEADER)
        fp = resp.getheader(SNAP_FP_HEADER)
        if seq is None:
            self.errors.append("read missing X-Commit-Seq")
            return False
        if resp.getheader(SESSION_HEADER) != self.sid:
            self.errors.append("session id not echoed")
        ob = (self.h.oracle.observe_final_read if final
              else self.h.oracle.observe_read)
        ob(self.sid, self.doc, int(seq), fp)
        return True

    def _write(self, w: int, delta: Batch) -> bool:
        """POST one delta; on 429, read while backing off and retry
        (the shed-and-read shape).  Returns ack success."""
        body = json_codec.dumps(delta)
        tid = f"{self.sid}-w{w:04d}"
        n_leaves = len(delta.ops)
        deadline = time.monotonic() + self.h.cfg.read_timeout_s
        while True:
            t0 = time.perf_counter()
            resp, raw = self._request(
                "POST", f"/docs/{self.doc}/ops", body=body,
                headers={TRACE_HEADER: tid, SESSION_HEADER: self.sid})
            ack_ms = (time.perf_counter() - t0) * 1e3
            if resp.status == 200:
                out = json.loads(raw)
                if not out.get("accepted") or \
                        out.get("trace_id") != tid:
                    self.errors.append(f"bad ack: {out}")
                    return False
                self.h.oracle.observe_write_ack(self.sid, self.doc, tid)
                self.writes_acked += 1
                self.leaves_acked += n_leaves
                self.ack_ms.append(ack_ms)
                return True
            if resp.status == 429:
                # interleaved reads during shedding: session
                # guarantees must hold THROUGH backpressure
                self.shed_429 += 1
                self._read()
                retry = min(float(resp.getheader("Retry-After") or 1),
                            0.05)
                time.sleep(retry)
                if time.monotonic() > deadline:
                    self.errors.append("429 shed never drained")
                    return False
                continue
            self.errors.append(
                f"write -> {resp.status}: {raw[:120]!r}")
            return False

    def run(self) -> None:
        try:
            resp, raw = self._request("POST",
                                      f"/docs/{self.doc}/replicas")
            if resp.status != 200:
                self.errors.append(f"replicas -> {resp.status}")
                return
            self.rid = json.loads(raw)["replica"]
            cfg = self.h.cfg
            for w in range(cfg.writes_per_session):
                if not self._write(w, self._delta(cfg.delta_size)):
                    return
                # editor sessions read after every write (the
                # read-your-writes probe); burst sessions only read at
                # burst boundaries so their writes coalesce.  The
                # read-heavy shape (reads_per_write > 1) re-polls the
                # document after each acked write
                if not self.burst or (w + 1) % 3 == 0:
                    for _ in range(max(1, cfg.reads_per_write)):
                        if not self._read():
                            return
            self._read()
        except Exception as e:      # noqa: BLE001 — harness boundary
            self.errors.append(repr(e))


class _Watcher(threading.Thread):
    """One long-poll watcher chasing a document's publish pointer
    through ``/watch``: park, wake, apply the resume mark
    off the wire, repeat.  Deliveries feed the oracle under the
    watcher's own session id — push reads must stay monotone through
    notify, resume, heartbeat, AND slow-consumer shed — and the
    heartbeat ETag rides back as ``If-None-Match`` so a caught-up
    re-poll parks instead of re-delivering the terminator window."""

    def __init__(self, harness: "_Harness", idx: int,
                 stop: threading.Event):
        super().__init__(name=f"loadgen-w{idx}", daemon=True)
        self.h = harness
        self.idx = idx
        self.stop = stop
        cfg = harness.cfg
        self.sid = f"watch-{idx:04d}"
        self.doc = f"load{idx % cfg.n_docs}"
        self.deliveries = 0     # windows received (notify + resume + shed)
        self.notifies = 0       # deliveries that woke a park
        self.heartbeats = 0     # empty timeout responses
        self.sheds = 0          # slow-consumer handoffs taken
        self.rejected_429 = 0   # admission sheds at the registry door
        self.bytes_rx = 0
        self.errors: List[str] = []

    def run(self) -> None:
        cfg = self.h.cfg
        since = 0
        etag: Optional[str] = None
        while not self.stop.is_set():
            try:
                hdrs = {SESSION_HEADER: self.sid}
                if etag is not None:
                    hdrs["If-None-Match"] = etag
                resp, raw = self.h.pool.request(
                    self.sid, "server", "127.0.0.1", self.h.port,
                    "GET",
                    f"/docs/{self.doc}/watch?since={since}"
                    f"&limit={cfg.watch_limit}"
                    f"&timeout={cfg.watch_timeout_s}",
                    headers=hdrs,
                    timeout=cfg.watch_timeout_s + 60)
            except (OSError, HTTPException) as e:
                if not self.stop.is_set():
                    self.errors.append(repr(e))
                return
            if resp.status == 429:
                self.rejected_429 += 1
                time.sleep(min(float(resp.getheader("Retry-After")
                                     or 1), 0.05))
                continue
            if resp.status == 404:
                time.sleep(0.01)          # doc not yet created
                continue
            if resp.status != 200:
                if not self.stop.is_set():
                    self.errors.append(f"watch -> {resp.status}")
                return
            event = resp.getheader(WATCH_EVENT_HEADER)
            etag = resp.getheader("ETag") or etag
            nxt = resp.getheader(SINCE_NEXT_HEADER)
            if nxt is not None:
                since = int(nxt)
            if event == "timeout":
                self.heartbeats += 1
                continue
            if event == "shed":
                self.sheds += 1
            elif event == "notify":
                self.notifies += 1
            self.deliveries += 1
            self.bytes_rx += len(raw)
            seq = resp.getheader(COMMIT_SEQ_HEADER)
            if seq is not None:
                self.h.oracle.observe_read(
                    self.sid, self.doc, int(seq),
                    resp.getheader(SNAP_FP_HEADER))


class _WatchSession:
    """Per-watcher state for the selector driver — the same public
    counters as :class:`_Watcher` so report aggregation is transport-
    blind."""

    __slots__ = ("idx", "sid", "doc", "since", "etag", "sock", "buf",
                 "out", "inflight", "connected", "resp_deadline",
                 "done", "deliveries", "notifies", "heartbeats",
                 "sheds", "rejected_429", "bytes_rx", "errors")

    def __init__(self, idx: int, n_docs: int):
        self.idx = idx
        self.sid = f"watch-{idx:04d}"
        self.doc = f"load{idx % n_docs}"
        self.since = 0
        self.etag: Optional[str] = None
        self.sock: Optional[socket.socket] = None
        self.buf = b""                 # accumulated response bytes
        self.out = b""                 # unsent request bytes
        self.inflight = False
        self.connected = False         # first request fully written
        self.resp_deadline = 0.0
        self.done = False
        self.deliveries = 0
        self.notifies = 0
        self.heartbeats = 0
        self.sheds = 0
        self.rejected_429 = 0
        self.bytes_rx = 0
        self.errors: List[str] = []


class _SelectorWatchers(threading.Thread):
    """The watcher population as ONE thread over raw keep-alive
    sockets: nonblocking connects in bounded waves (the
    server's accept backlog is finite), a per-session request/response
    state machine, and a retry heap for the 429/404 backoffs.  Each
    completed response runs the SAME delivery logic as the thread
    client — event taxonomy, ``If-None-Match`` ETag carry, resume-mark
    advance, oracle ``observe_read`` — so the push-read session
    guarantees are checked identically at any population size."""

    CONNECT_WAVE = 128                 # outstanding connects at once

    def __init__(self, harness: "_Harness", n: int,
                 stop: threading.Event):
        super().__init__(name="loadgen-watch-selector", daemon=True)
        self.h = harness
        self.stop = stop
        cfg = harness.cfg
        self.sessions = [_WatchSession(i, cfg.n_docs)
                         for i in range(n)]
        self.sel = selectors.DefaultSelector()
        self._delays: List = []        # heap of (wake_at, idx)
        self._pending = list(range(n))  # not yet connected
        self._live = 0
        self._connecting = 0           # handshakes in progress

    # -- request plumbing --------------------------------------------------

    def _request_bytes(self, ws: _WatchSession) -> bytes:
        cfg = self.h.cfg
        etag = (f"If-None-Match: {ws.etag}\r\n"
                if ws.etag is not None else "")
        return (f"GET /docs/{ws.doc}/watch?since={ws.since}"
                f"&limit={cfg.watch_limit}"
                f"&timeout={cfg.watch_timeout_s} HTTP/1.1\r\n"
                f"Host: loadgen\r\n"
                f"{SESSION_HEADER}: {ws.sid}\r\n{etag}\r\n").encode()

    def _connect(self, ws: _WatchSession) -> None:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setblocking(False)
        try:
            s.connect(("127.0.0.1", self.h.port))
        except BlockingIOError:
            pass
        except OSError as e:
            ws.errors.append(repr(e))
            ws.done = True
            s.close()
            return
        ws.sock = s
        ws.out = self._request_bytes(ws)
        ws.inflight = True
        ws.resp_deadline = time.monotonic() + \
            self.h.cfg.watch_timeout_s + 60
        self._live += 1
        self._connecting += 1
        self.sel.register(s, selectors.EVENT_WRITE, ws)

    def _send_next(self, ws: _WatchSession, delay: float = 0.0) -> None:
        if self.stop.is_set():
            self._close(ws)
            return
        if delay > 0.0:
            heapq.heappush(self._delays,
                           (time.monotonic() + delay, ws.idx))
            return
        ws.out = self._request_bytes(ws)
        ws.inflight = True
        ws.resp_deadline = time.monotonic() + \
            self.h.cfg.watch_timeout_s + 60
        self.sel.modify(ws.sock, selectors.EVENT_WRITE, ws)

    def _close(self, ws: _WatchSession, err: Optional[str] = None) -> None:
        if err is not None and not self.stop.is_set():
            ws.errors.append(err)
        if ws.sock is not None:
            try:
                self.sel.unregister(ws.sock)
            except (KeyError, ValueError):
                pass
            try:
                ws.sock.close()
            except OSError:
                pass
            ws.sock = None
            self._live -= 1
            if not ws.connected:
                self._connecting -= 1
        ws.done = True

    # -- response handling -------------------------------------------------

    def _on_writable(self, ws: _WatchSession) -> None:
        err = ws.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
        if err:
            self._close(ws, f"connect errno {err}")
            return
        try:
            n = ws.sock.send(ws.out)
        except (BlockingIOError, InterruptedError):
            return
        except OSError as e:
            self._close(ws, repr(e))
            return
        ws.out = ws.out[n:]
        if not ws.out:
            if not ws.connected:
                ws.connected = True
                self._connecting -= 1
            self.sel.modify(ws.sock, selectors.EVENT_READ, ws)

    def _on_readable(self, ws: _WatchSession) -> None:
        try:
            chunk = ws.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError as e:
            self._close(ws, repr(e))
            return
        if not chunk:
            self._close(ws, None if self.stop.is_set()
                        else "server closed connection")
            return
        ws.buf += chunk
        while ws.inflight:
            end = ws.buf.find(b"\r\n\r\n")
            if end < 0:
                return
            head = ws.buf[:end]
            m = re.search(rb"Content-Length: (\d+)", head)
            clen = int(m.group(1)) if m else 0
            if len(ws.buf) < end + 4 + clen:
                return
            body = ws.buf[end + 4:end + 4 + clen]
            ws.buf = ws.buf[end + 4 + clen:]
            ws.inflight = False
            self._process(ws, head, body)

    def _process(self, ws: _WatchSession, head: bytes,
                 body: bytes) -> None:
        """One response, same branch structure as ``_Watcher.run``."""
        status = int(head.split(None, 2)[1])
        hdrs = {}
        for line in head.split(b"\r\n")[1:]:
            k, _, v = line.partition(b": ")
            hdrs[k.decode("latin-1").lower()] = v.decode("latin-1")
        if hdrs.get("connection", "").lower() == "close":
            self._close(ws, f"connection closed on {status}")
            return
        if status == 429:
            ws.rejected_429 += 1
            self._send_next(ws, delay=min(
                float(hdrs.get("retry-after") or 1), 0.05))
            return
        if status == 404:
            self._send_next(ws, delay=0.01)
            return
        if status != 200:
            self._close(ws, f"watch -> {status}")
            return
        event = hdrs.get(WATCH_EVENT_HEADER.lower())
        ws.etag = hdrs.get("etag", ws.etag)
        nxt = hdrs.get(SINCE_NEXT_HEADER.lower())
        if nxt is not None:
            ws.since = int(nxt)
        if event == "timeout":
            ws.heartbeats += 1
            self._send_next(ws)
            return
        if event == "shed":
            ws.sheds += 1
        elif event == "notify":
            ws.notifies += 1
        ws.deliveries += 1
        ws.bytes_rx += len(body)
        seq = hdrs.get(COMMIT_SEQ_HEADER.lower())
        if seq is not None:
            self.h.oracle.observe_read(
                ws.sid, ws.doc, int(seq),
                hdrs.get(SNAP_FP_HEADER.lower()))
        self._send_next(ws)

    # -- the loop ----------------------------------------------------------

    def run(self) -> None:
        try:
            self._run()
        finally:
            for ws in self.sessions:
                if not ws.done:
                    self._close(ws)
            self.sel.close()

    def _run(self) -> None:
        drain_by: Optional[float] = None
        while True:
            # connect wave: keep the in-progress herd bounded so the
            # listener's backlog (128) never RSTs a wave
            while self._pending and not self.stop.is_set() \
                    and self._connecting < self.CONNECT_WAVE:
                self._connect(self.sessions[self._pending.pop(0)])
            now = time.monotonic()
            while self._delays and self._delays[0][0] <= now:
                _, idx = heapq.heappop(self._delays)
                ws = self.sessions[idx]
                if not ws.done:
                    self._send_next(ws)
            timeout = 0.2
            if self._delays:
                timeout = max(0.0, min(
                    timeout, self._delays[0][0] - now))
            for key, mask in self.sel.select(timeout):
                ws = key.data
                if ws.done:
                    continue
                if mask & selectors.EVENT_WRITE:
                    self._on_writable(ws)
                if mask & selectors.EVENT_READ and not ws.done:
                    self._on_readable(ws)
            now = time.monotonic()
            for ws in self.sessions:
                if not ws.done and ws.inflight \
                        and now > ws.resp_deadline:
                    self._close(ws, "response deadline")
            if self.stop.is_set():
                # teardown parity with the thread client: in-flight
                # parks drain at their budget (the server heartbeats
                # them out), idle sockets close now
                if drain_by is None:
                    drain_by = now + self.h.cfg.watch_timeout_s + 30
                for ws in self.sessions:
                    if not ws.done and not ws.inflight:
                        self._close(ws)
                if all(ws.done for ws in self.sessions) \
                        or now > drain_by:
                    return


class _Harness:
    def __init__(self, cfg: LoadgenConfig, engine: ServingEngine,
                 port: int, oracle: oracle_mod.SessionOracle):
        from ..cluster.pool import ConnectionPool
        self.cfg = cfg
        self.engine = engine
        self.port = port
        self.oracle = oracle
        # pooled keep-alive client connections — the same
        # pool the fleet paths use, plain factory (no chaos in
        # single-server mode)
        self.pool = ConnectionPool()


def run(cfg: Optional[LoadgenConfig] = None,
        engine: Optional[ServingEngine] = None,
        oracle: Optional[oracle_mod.SessionOracle] = None
        ) -> Dict[str, Any]:
    """One closed-loop run against a fresh in-process HTTP server.
    Returns the report dict (headline numbers + oracle verdict).  Pass
    ``engine``/``oracle`` to control recorder capacity or fault
    injection from tests."""
    from ..service import make_server

    cfg = cfg or LoadgenConfig()
    own_engine = engine is None
    engine = engine if engine is not None else ServingEngine(
        max_queue_requests=cfg.max_queue_requests, device=cfg.device)
    oracle = oracle if oracle is not None else oracle_mod.SessionOracle()
    oracle.attach_engine(engine)
    srv = make_server(port=0, store=engine)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    harness = None
    try:
        harness = _Harness(cfg, engine, srv.server_port, oracle)
        return _run(cfg, engine, oracle, srv, harness)
    finally:
        # pool teardown mirrors run_fleet's finally: a mid-run
        # exception must not leak idle keep-alive sockets (each pins a
        # server handler thread on the next request line).  Harness
        # construction sits INSIDE the try so a failure there still
        # tears the server/oracle/engine down below.
        if harness is not None:
            harness.pool.close()
        # a mid-run exception must not leak the server, the scheduler
        # thread, or — worst in a test process — the oracle's listener
        # on a shared flight recorder (it would keep ingesting every
        # later run's commits)
        srv.shutdown()
        srv.server_close()
        oracle.detach_engine(engine)
        if own_engine:
            engine.close()


def _run(cfg: LoadgenConfig, engine: ServingEngine,
         oracle: oracle_mod.SessionOracle, srv,
         harness: _Harness) -> Dict[str, Any]:
    from ..parallel import opsaxis
    # the report's shard audit samples the run's first sharded merge
    opsaxis.arm_audit()
    sessions = [_Session(harness, i) for i in range(cfg.n_sessions)]
    # watchers start FIRST so the earliest generations are delivered
    # as notifies (parked wakes), not just resumes of history
    watch_stop = threading.Event()
    use_selector = (cfg.watch_selector if cfg.watch_selector
                    is not None else cfg.n_watchers >= 64)
    if cfg.n_watchers and use_selector:
        watch_driver = _SelectorWatchers(harness, cfg.n_watchers,
                                         watch_stop)
        watch_driver.start()
        watchers: List[Any] = watch_driver.sessions
        watch_joiners: List[threading.Thread] = [watch_driver]
    else:
        watchers = [_Watcher(harness, i, watch_stop)
                    for i in range(cfg.n_watchers)]
        watch_joiners = watchers
        for wt in watchers:
            wt.start()

    staged = False
    if cfg.stage_first_round and cfg.n_sessions >= 2:
        # guarantee ≥1 genuinely coalesced multi-writer commit: hold
        # the scheduler while the first wave of writes queues up, then
        # release it as one fused round per document
        engine.scheduler.pause()
    t_start = time.perf_counter()
    try:
        for s in sessions:
            s.start()
        if cfg.stage_first_round and cfg.n_sessions >= 2:
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if any(len(d.queue) >= 2 for d in engine.docs()):
                    staged = True
                    break
                time.sleep(0.005)
    finally:
        if cfg.stage_first_round and cfg.n_sessions >= 2:
            engine.scheduler.resume()

    giant_err: List[str] = []
    giant_s = None
    if cfg.giant_ops:
        # the giant-merge racer: one chunk-spanning push lands on doc 0
        # mid-run while every session on that document keeps reading.
        # Under a small admission queue the giant gets shed like anyone
        # else — it backs off through the 429s until admitted.
        def giant():
            nonlocal giant_s

            def greq(method, path, body=None, headers=None):
                return harness.pool.request(
                    "sess-giant", "server", "127.0.0.1", harness.port,
                    method, path, body=body, headers=headers,
                    timeout=600)

            try:
                resp, raw = greq("POST", "/docs/load0/replicas")
                rid = json.loads(raw)["replica"]
                ops, prev = [], 0
                for i in range(cfg.giant_ops):
                    ts = rid * OFFSET + i + 1
                    ops.append(Add(ts, (prev,), i % 997))
                    prev = ts
                body = json_codec.dumps(Batch(tuple(ops)))
                deadline = time.monotonic() + cfg.read_timeout_s
                t0 = time.perf_counter()
                while True:
                    resp, raw = greq(
                        "POST", "/docs/load0/ops", body=body,
                        headers={TRACE_HEADER: "giant-racer-push",
                                 SESSION_HEADER: "sess-giant"})
                    if resp.status == 429:
                        if time.monotonic() > deadline:
                            giant_err.append("giant 429 never drained")
                            return
                        time.sleep(min(float(
                            resp.getheader("Retry-After") or 1), 0.1))
                        continue
                    break
                out = json.loads(raw)
                if resp.status != 200 or not out.get("accepted"):
                    giant_err.append(f"giant -> {resp.status}")
                else:
                    giant_s = time.perf_counter() - t0
                    oracle.observe_write_ack("sess-giant", "load0",
                                             "giant-racer-push")
            except Exception as e:  # noqa: BLE001 — harness boundary
                giant_err.append(repr(e))
        giant_thread = threading.Thread(target=giant, daemon=True)
        giant_thread.start()
    for s in sessions:
        s.join(600)
    if cfg.giant_ops:
        giant_thread.join(600)
    load_wall_s = time.perf_counter() - t_start
    # release the watchers: an in-flight park drains at its budget
    watch_stop.set()
    for wt in watch_joiners:
        wt.join(cfg.watch_timeout_s + 120)

    # quiescence: drain everything admitted above and flush the flight
    # stream (the barrier — no records_total polling), then the final
    # convergence read round
    flushed = engine.flush(timeout=120)
    conn = HTTPConnection("127.0.0.1", harness.port, timeout=60)
    try:
        for s in sessions:
            conn.request("GET", f"/docs/{s.doc}",
                         headers={SESSION_HEADER: s.sid})
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status == 200:
                oracle.observe_final_read(
                    s.sid, s.doc,
                    int(resp.getheader(COMMIT_SEQ_HEADER)),
                    resp.getheader(SNAP_FP_HEADER))
        # the scrape surface must hold (strictly) with the oracle
        # families present at the end of a loaded run
        conn.request("GET", "/metrics/prom")
        prom_text = conn.getresponse().read().decode()
    finally:
        conn.close()
    fams = prom_mod.parse_text(prom_text)
    violations = oracle.finalize()

    read_ms = sorted(m for s in sessions for m in s.read_ms)
    ack_ms = sorted(m for s in sessions for m in s.ack_ms)
    errors = [e for s in sessions for e in s.errors] + giant_err \
        + [e for wt in watchers for e in wt.errors]
    merged = sum(d.ops_merged for d in engine.docs())
    n = len(read_ms)
    na = len(ack_ms)
    ost = oracle.stats()

    # ack-latency breakdown off the flight stream: where a
    # committed write's latency went — merge compute vs pipeline queue
    # wait vs the fsync itself.  Pipelined engines hide the queue wait
    # under the NEXT round's compute; serialized engines pay all three
    # in series, which is exactly the contrast the pipeline headline
    # bench reports.
    stage_rows = [r.stages_ms for r in engine.flight.records()
                  if r.outcome in ("committed", "partial")]

    def _stage_stats(keys):
        vals = sorted(sum(s.get(k, 0.0) for k in keys)
                      for s in stage_rows)
        if not vals:
            return None
        return {"mean": round(sum(vals) / len(vals), 3),
                "p50": round(vals[len(vals) // 2], 3),
                "p99": round(vals[min(len(vals) - 1,
                                      (99 * len(vals)) // 100)], 3)}

    ack_breakdown = {
        "compute": _stage_stats(("fuse", "merge", "publish",
                                 "batch_prepare", "batched_launch")),
        "fsync_queue": _stage_stats(("wal_fsync_queued",)),
        "fsync_wait": _stage_stats(("wal_fsync",)),
        # the end-to-end durability stall per COMMIT (queue + wait
        # summed before the percentile): the backend-fair A/B number —
        # the serialized lane books its convoy in the queue stage, a
        # completion-driven lane in the wait stage, and only the sum
        # compares the two without flattering either accounting
        "fsync_stall": _stage_stats(("wal_fsync_queued",
                                     "wal_fsync")),
        "wal_append": _stage_stats(("wal_append",)),
        # disaggregated merge tier: round-trip to
        # the worker pool per remote-routed commit (None when the tier
        # is off or nothing routed)
        "remote_merge": _stage_stats(("remote_merge",)),
        # which group-commit sync lane produced these numbers: the
        # A/B legs label the breakdown with the backend that
        # actually RAN (auto-detect may downgrade a requested uring),
        # and fsync_queue/fsync_wait are per-DOC — the completion-
        # driven lane resolves each doc at ITS durability, so the
        # split shows exactly what that buys vs one shared round stamp
        "sync_backend": (engine.sync_worker.stats().get("backend")
                         if getattr(engine, "sync_worker", None)
                         is not None else None),
    }
    out = {
        "harness": "loadgen",
        "sessions": cfg.n_sessions,
        "docs": cfg.n_docs,
        "staged_first_round": staged,
        "writes_acked": sum(s.writes_acked for s in sessions)
        + (1 if cfg.giant_ops and not giant_err else 0),
        "leaves_acked": sum(s.leaves_acked for s in sessions)
        + (cfg.giant_ops if cfg.giant_ops and not giant_err else 0),
        "ops_merged": merged,
        "load_wall_s": round(load_wall_s, 3),
        "ops_per_sec": round(merged / load_wall_s, 1),
        "reads": n,
        "reads_per_sec": round(n / load_wall_s, 1),
        "read_p50_ms": round(read_ms[n // 2], 3) if n else None,
        "read_p99_ms": round(read_ms[(99 * n) // 100], 3) if n else None,
        "read_max_ms": round(read_ms[-1], 3) if n else None,
        # ack latency of successful writes (durability tax visible
        # here when a WAL is armed: + wal_append + wal_fsync)
        "ack_p50_ms": round(ack_ms[na // 2], 3) if na else None,
        "ack_p99_ms": round(ack_ms[min(na - 1, (99 * na) // 100)], 3)
        if na else None,
        "wal_sync": engine.wal_sync
        if engine.durable_dir is not None else "off",
        "wal": ({"fsyncs": (engine.shared_wal.telemetry()["fsyncs"]
                            if engine.shared_wal is not None else
                            sum(d.wal.telemetry()["fsyncs"]
                                for d in engine.docs()
                                if d.wal is not None)),
                 "appends": sum(d.wal.telemetry()["appends"]
                                for d in engine.docs()
                                if d.wal is not None)}
                if engine.durable_dir is not None else None),
        # shared-stream amortization (GRAFT_WAL_SHARED): the raw
        # counters the fsyncs-per-round headline derives from
        "wal_shared": (engine.shared_wal.telemetry()
                       if getattr(engine, "shared_wal", None)
                       is not None else None),
        # pipelined commit path + maintenance lane:
        # where ack latency went, and what left the scheduler thread
        "ack_breakdown_ms": ack_breakdown,
        "pipeline": (engine.sync_worker.stats()
                     if getattr(engine, "sync_worker", None)
                     is not None else None),
        "maint": (engine.maintenance.stats()
                  if getattr(engine, "maintenance", None)
                  is not None else None),
        "shed_429": sum(s.shed_429 for s in sessions),
        "giant_ops": cfg.giant_ops,
        "giant_commit_s": round(giant_s, 3) if giant_s else None,
        # read-path egress telemetry: the per-doc encoded-
        # body caches aggregated, plus the client connection pool —
        # reuses ≫ opens is the persistent-connection proof
        "readcache": _aggregate_readcache(engine),
        # watch fan-out: client-side delivery counts next
        # to the server registries' delivery-class stats + merged
        # notify-latency percentiles
        "watch": ({
            "watchers": cfg.n_watchers,
            "client": "selector" if use_selector else "threads",
            "deliveries": sum(wt.deliveries for wt in watchers),
            "notifies": sum(wt.notifies for wt in watchers),
            "heartbeats": sum(wt.heartbeats for wt in watchers),
            "sheds": sum(wt.sheds for wt in watchers),
            "rejected_429": sum(wt.rejected_429 for wt in watchers),
            "bytes_rx": sum(wt.bytes_rx for wt in watchers),
            "deliveries_per_sec": round(
                sum(wt.deliveries for wt in watchers) / load_wall_s,
                1),
            "server": _aggregate_watch(engine),
        } if watchers else None),
        "connpool": harness.pool.stats(),
        "flushed": flushed,
        "oracle": ost,
        "violations": violations,
        "prom_families": len(fams),
        "prom_oracle_families": sorted(
            f for f in fams if f.startswith("crdt_oracle_")),
        "errors": errors[:8],
        "flight": engine.flight.stats(),
        # ops-axis sharded-merge routing: the runtime counters plus
        # the shard audit of the run's first routed merge
        "opsaxis": _opsaxis_report(),
        # disaggregated merge tier: route/fallback
        # counters, worker pool health, achieved widths — None when
        # the tier is off (the A/B legs key off exactly this)
        "mergetier": (engine.mergetier.stats()
                      if getattr(engine, "mergetier", None)
                      is not None else None),
    }
    return out


def _aggregate_readcache(engine) -> Dict[str, Any]:
    """Engine-wide sum of the per-doc read-cache counters (the bench
    headline's cache half)."""
    out = {"enabled": engine.readcache_enabled,
           "hits": 0, "misses": 0, "encoded_bytes": 0,
           "window_evictions": 0, "not_modified": 0}
    for d in engine.docs():
        rc = getattr(d, "readcache", None)
        if rc is None:
            continue
        snap = rc.snapshot()
        for k in ("hits", "misses", "encoded_bytes",
                  "window_evictions", "not_modified"):
            out[k] += snap[k]
    return out


def _aggregate_watch(engine) -> Dict[str, Any]:
    """Engine-wide sum of the per-doc watch-registry stats plus the
    bucket-merged notify-latency percentiles (serve/watch.py)."""
    from ..serve.watch import merge_notify_hists
    out = {"admitted": 0, "rejected": 0, "notifies": 0, "resumes": 0,
           "heartbeats": 0, "shed_slow": 0, "reaped": 0,
           "registered": 0, "parked": 0}
    exports = []
    for d in engine.docs():
        reg = getattr(d, "watch", None)
        if reg is None:
            continue
        snap = reg.snapshot()
        for k in out:
            out[k] += snap.get(k, 0)
        exports.append(reg.stats.notify_ms.export())
    out["notify_ms"] = merge_notify_hists(exports)
    return out


def _opsaxis_report():
    from ..parallel import opsaxis
    out = opsaxis.stats()
    opsaxis.arm_audit(False)
    try:
        audit = opsaxis.audit_last()
    except Exception as e:  # pragma: no cover - disclosure over failure
        audit = {"error": repr(e)[:200]}
    if audit is not None:
        out["audit"] = audit
    return out


# -- fleet mode --------------------------------------------------------------
#
# ``run_fleet`` drives an in-process replica fleet (N FleetServers on
# their own localhost ports sharing one MemoryKV) instead of one
# server: sessions enter through a home server (the gateway forwards
# writes to each document's primary), spray reads across replicas
# (every read observed under the oracle key ``doc@replica.epoch``, so
# monotonic reads are checked per replica INCARNATION — a restarted
# server's fresh seq counter must not read as a regression), probe
# read-your-writes through the committing primary, and sample
# anti-entropy lag by timing ack → visible-on-another-replica.  With
# ``kill_mid_run`` the giant doc's primary is crashed mid-merge (no
# lease release), the giant re-pushes through a survivor once failover
# reroutes the doc, and the server rejoins under its old name with a
# bumped fencing epoch.  At quiescence every live replica's
# replica-independent state fingerprint feeds the oracle's
# cross-replica convergence check.


class _FleetHarness:
    def __init__(self, cfg: LoadgenConfig,
                 oracle: oracle_mod.SessionOracle):
        from ..cluster import ConnectionPool, MemoryKV, NetChaos
        from ..cluster import netchaos as netchaos_mod
        self.cfg = cfg
        self.oracle = oracle
        self.kv = MemoryKV()
        # one shared fault plan models ONE network for the whole
        # in-process fleet (link decision streams are per (src, dst))
        self.netchaos = NetChaos(cfg.seed, cfg.netchaos_spec) \
            if cfg.netchaos_spec else None
        # pooled client links: session/giant traffic leases
        # from the chaos pool when client links are armed (faults ride
        # the pooled connections), the clean pool otherwise; harness
        # verification requests always ride the clean pool
        self.pool = ConnectionPool()
        self.chaos_pool = ConnectionPool(
            connect=lambda src, dst, host, port, timeout:
            netchaos_mod.connect(self.netchaos, src, dst, host, port,
                                 timeout)) \
            if self.netchaos is not None else None
        self.servers: Dict[str, Any] = {}       # live name -> FleetServer
        self.dead: List[str] = []
        self.lock = threading.Lock()
        self.acked_total = 0                    # kill-timing signal
        self.lag_s: List[float] = []
        self.lag_censored = 0                   # probes lost to deadline
        self.read_ms_primary: List[float] = []
        self.read_ms_replica: List[float] = []
        self.errors: List[str] = []
        self.kill_report: Dict[str, Any] = {}

    # -- fleet lifecycle --------------------------------------------------

    def spawn(self, name: str):
        from ..cluster import FleetServer
        from ..obs import flight as flight_mod
        from ..serve import ServingEngine
        engine = ServingEngine(
            max_queue_requests=self.cfg.max_queue_requests,
            flight=flight_mod.FlightRecorder(), device=self.cfg.device)
        fs = FleetServer(name, self.kv, engine=engine,
                         ttl_s=self.cfg.lease_ttl_s,
                         ae_interval_s=self.cfg.ae_interval_s,
                         delta_cap=self.cfg.delta_cap,
                         netchaos=self.netchaos)
        node = fs.node

        def listen(rec):
            # commit records are observed under the per-incarnation
            # doc key, matching how reads of this server are observed.
            # The epoch is read at RECORD time, not spawn time: a
            # mid-run lease re-acquisition (renewal missed under load)
            # bumps the epoch in place, and acks/reads key on the
            # bumped value — a frozen tag would orphan every later ack
            self.oracle.ingest_commit_record(
                {**rec,
                 "doc_id": f"{rec['doc_id']}@{name}.{node.epoch()}"})

        engine.flight.add_listener(listen)
        with self.lock:
            self.servers[name] = fs
        return fs

    def crash(self, name: str) -> None:
        with self.lock:
            fs = self.servers.pop(name)
            self.dead.append(name)
        fs.crash()

    def live(self) -> List[Any]:
        with self.lock:
            return list(self.servers.values())

    def primary_name(self, doc: str) -> Optional[str]:
        for fs in self.live():
            return fs.node.primary_for(doc)
        return None

    def wait_ring_stable(self, timeout_s: float = 15.0) -> None:
        """Block until every live node's ring sees the whole fleet.
        Nodes join one at a time, so a just-started node's cached ring
        briefly contains only the members that had leases when IT
        looked — a write entering through it then applies at a
        not-yet-primary and the session's next write races
        anti-entropy for its own anchors.  Real deployments converge
        within one ring TTL of the last join; the harness must not
        start traffic inside that window."""
        want = len(self.live())
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(len(fs.node.refresh_ring()) == want
                   for fs in self.live()):
                return
            time.sleep(0.02)
        self.errors.append("fleet ring never stabilized")

    # -- transport --------------------------------------------------------

    def request(self, fs, method: str, path: str, body=None,
                headers=None, timeout: float = 60.0,
                chaos_src: Optional[str] = None):
        """One POOLED request to a fleet member.  ``chaos_src`` (a
        client link name) routes it through the armed fault plan's
        pool — session traffic under ``netchaos_clients``; harness
        verification requests always ride the clean pool so the
        convergence checks measure the fleet, not the harness'
        luck."""
        if chaos_src is not None and self.chaos_pool is not None \
                and self.cfg.netchaos_clients:
            pool = self.chaos_pool
        else:
            pool = self.pool
        return pool.request(chaos_src or "harness", fs.name,
                            "127.0.0.1", fs.port, method, path,
                            body=body, headers=headers,
                            timeout=timeout)

    def close_pools(self) -> None:
        self.pool.close()
        if self.chaos_pool is not None:
            self.chaos_pool.close()

    def observe_read(self, sid: str, doc: str, resp,
                     final: bool = False) -> None:
        seq = resp.getheader(COMMIT_SEQ_HEADER)
        name = resp.getheader("X-Replica-Name")
        epoch = resp.getheader("X-Replica-Epoch")
        if seq is None or name is None:
            self.errors.append(f"read of {doc} missing fleet headers")
            return
        key = f"{doc}@{name}.{epoch}"
        ob = (self.oracle.observe_final_read if final
              else self.oracle.observe_read)
        ob(sid, key, int(seq), resp.getheader(SNAP_FP_HEADER))


class _FleetSession(threading.Thread):
    """One closed-loop fleet session: writes through a home entry
    server (rotating to a survivor on connection failure, then
    idempotently re-pushing its whole history so an acked-but-unsynced
    write can never be lost with its primary), RYW probes through the
    committing server, sprayed reads + lag probes on other replicas."""

    def __init__(self, h: _FleetHarness, idx: int):
        super().__init__(name=f"fleet-s{idx}", daemon=True)
        self.h = h
        self.idx = idx
        cfg = h.cfg
        self.sid = f"fsess-{idx:04d}"
        self.doc = f"load{idx % cfg.n_docs}"
        self.rng = random.Random(cfg.seed * 52361 + idx)
        self.entry = h.live()[idx % len(h.live())].name
        self.rid: Optional[int] = None
        self.counter = 0
        self.alive: List[int] = []
        self.val_by_ts: Dict[int, str] = {}
        self.deltas: List[str] = []       # encoded history (re-push)
        self.writes_acked = 0
        self.leaves_acked = 0
        self.shed_429 = 0
        self.retry_409 = 0
        self.read_refused_503 = 0
        self.errors: List[str] = []

    def _entry_server(self):
        with self.h.lock:
            fs = self.h.servers.get(self.entry)
            if fs is None:                # entry died: rotate
                names = sorted(self.h.servers)
                if not names:
                    return None
                self.entry = names[self.idx % len(names)]
                fs = self.h.servers[self.entry]
        return fs

    def _delta(self) -> Batch:
        cfg = self.h.cfg
        ops = []
        for _ in range(cfg.delta_size):
            if self.alive and self.rng.random() < cfg.backspace_p:
                ops.append(Delete((self.alive.pop(),)))
            else:
                self.counter += 1
                ts = self.rid * OFFSET + self.counter
                anchor = self.alive[-1] if self.alive else 0
                val = f"s{self.idx}:{self.counter}"
                ops.append(Add(ts, (anchor,), val))
                self.alive.append(ts)
                self.val_by_ts[ts] = val
        return Batch(tuple(ops))

    def surviving_values(self) -> List[str]:
        """Values acked AND never backspaced by this session — the set
        the converged document must contain."""
        return [self.val_by_ts[ts] for ts in self.alive]

    def _post(self, body: str, tid: str):
        """One write attempt chain: 429 backoff + 503 failover wait +
        connection-failure entry rotation, bounded by the deadline.
        Returns the ack dict or None (error recorded)."""
        deadline = time.monotonic() + self.h.cfg.read_timeout_s
        while time.monotonic() < deadline:
            fs = self._entry_server()
            if fs is None:
                break
            try:
                resp, raw = self.h.request(
                    fs, "POST", f"/docs/{self.doc}/ops", body=body,
                    headers={TRACE_HEADER: tid,
                             SESSION_HEADER: self.sid},
                    chaos_src=self.sid)
            except (OSError, HTTPException):
                self._rotate_and_repush()
                continue
            if resp.status == 200:
                return json.loads(raw)
            if resp.status == 429:
                self.shed_429 += 1
                time.sleep(min(float(
                    resp.getheader("Retry-After") or 1), 0.05))
                continue
            if resp.status == 503:
                # primary unreachable: wait out (part of) the lease
                # TTL and retry — failover reroutes the doc
                time.sleep(min(float(
                    resp.getheader("Retry-After") or 1), 0.25))
                continue
            if resp.status == 409:
                # causality gap AT THE CURRENT PRIMARY: our anchors
                # were acked by an earlier primary and haven't synced
                # (or died with it).  They exist in OUR history —
                # re-push it in order through the entry (duplicates
                # absorb), then retry; anti-entropy makes this
                # transient, never a hard failure
                self.retry_409 += 1
                self._repush(fs)
                time.sleep(0.05)
                continue
            self.errors.append(f"write -> {resp.status}: {raw[:120]!r}")
            return None
        self.errors.append("write never acked before deadline")
        return None

    def _rotate_and_repush(self) -> None:
        """The entry server died under us: move to a survivor and
        idempotently re-push the session's whole history (an acked
        write whose primary died unsynced exists nowhere else — the
        CRDT absorbs every duplicate, so replay is free of harm)."""
        self.entry = "?"                  # force re-pick
        fs = self._entry_server()
        if fs is not None:
            self._repush(fs)

    def _repush(self, fs) -> None:
        """Replay the session's whole delta history in order through
        ``fs`` (each delta restores the anchors of the next; the CRDT
        absorbs every duplicate)."""
        for k, body in enumerate(self.deltas):
            try:
                self.h.request(
                    fs, "POST", f"/docs/{self.doc}/ops", body=body,
                    headers={TRACE_HEADER:
                             f"{self.sid}-rp{k:04d}-{self.rng.randrange(16**4):04x}",
                             SESSION_HEADER: self.sid},
                    chaos_src=self.sid)
            except (OSError, HTTPException):
                return                    # next _post attempt rotates

    def _read_via(self, fs, final: bool = False,
                  probe_value: Optional[str] = None) -> bool:
        t0 = time.perf_counter()
        try:
            resp, raw = self.h.request(
                fs, "GET", f"/docs/{self.doc}",
                headers={SESSION_HEADER: self.sid},
                chaos_src=self.sid)
        except (OSError, HTTPException):
            return False
        ms = (time.perf_counter() - t0) * 1e3
        if resp.status == 404:
            return False                  # not yet synced to this node
        if resp.status == 503 and resp.getheader("Retry-After"):
            # the server's honest refusals, not session errors: a
            # rejoining replica still catching the doc up (503 +
            # Retry-After + X-Catchup-Remaining) or the bounded-staleness gate
            # declining to serve a too-stale local generation — both
            # mean "ask another replica / come back", exactly like the
            # 404 branch above
            self.read_refused_503 += 1
            return False
        if resp.status != 200:
            self.errors.append(f"read -> {resp.status}")
            return False
        primary = self.h.primary_name(self.doc)
        served = resp.getheader("X-Replica-Name")
        (self.h.read_ms_primary if served == primary
         else self.h.read_ms_replica).append(ms)
        self.h.observe_read(self.sid, self.doc, resp, final=final)
        if probe_value is not None:
            return probe_value in json.loads(raw).get("values", [])
        return True

    def _lag_probe(self, committed_on: str, value: str,
                   t_ack: float) -> None:
        """Time ack → visible on a replica OTHER than the committing
        one: the client-observed anti-entropy lag.  The target is
        re-picked per attempt (it may be the server the killer just
        crashed); a probe that outlives the deadline is CENSORED — a
        latency sample lost to contention, not a sync failure, which
        the quiescence convergence + acked-value checks still cover."""
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            others = [fs for fs in self.h.live()
                      if fs.name != committed_on]
            if not others:
                return
            target = self.rng.choice(others)
            if self._read_via(target, probe_value=value):
                self.h.lag_s.append(time.monotonic() - t_ack)
                return
            time.sleep(0.02)
        with self.h.lock:
            self.h.lag_censored += 1

    def _allocate_replica(self) -> Optional[int]:
        """Claim a fleet-unique replica id through ANY live server —
        rotating off an entry that dies mid-allocation (the killer may
        fire while sessions are still starting up)."""
        deadline = time.monotonic() + self.h.cfg.read_timeout_s
        while time.monotonic() < deadline:
            fs = self._entry_server()
            if fs is None:
                return None
            try:
                resp, raw = self.h.request(
                    fs, "POST", f"/docs/{self.doc}/replicas",
                    timeout=30, chaos_src=self.sid)
            except (OSError, HTTPException):
                self.entry = "?"            # re-pick a survivor
                time.sleep(0.1)
                continue
            if resp.status == 200:
                return json.loads(raw)["replica"]
            time.sleep(0.2)
        return None

    def run(self) -> None:
        try:
            self.rid = self._allocate_replica()
            if self.rid is None:
                self.errors.append("replica id never allocated")
                return
            cfg = self.h.cfg
            for w in range(cfg.writes_per_session):
                delta = self._delta()
                body = json_codec.dumps(delta)
                self.deltas.append(body)
                tid = f"{self.sid}-w{w:04d}"
                ack = self._post(body, tid)
                if ack is None:
                    return
                if not ack.get("accepted"):
                    self.errors.append(f"bad ack: {ack}")
                    return
                served = ack.get("served_by") or {}
                akey = (f"{self.doc}@{served.get('name')}."
                        f"{served.get('epoch')}")
                self.h.oracle.observe_write_ack(self.sid, akey,
                                                ack["trace_id"])
                t_ack = time.monotonic()
                self.writes_acked += 1
                self.leaves_acked += len(delta.ops)
                with self.h.lock:
                    self.h.acked_total += 1
                # RYW probe through the COMMITTING server (the one
                # place the guarantee holds pre-sync)
                with self.h.lock:
                    committer = self.h.servers.get(served.get("name"))
                if committer is not None:
                    self._read_via(committer)
                # sprayed replica-local read (staleness is legal and
                # wire-observable; monotonicity must hold per replica)
                if self.rng.random() < cfg.spray_read_p:
                    self._read_via(self.rng.choice(self.h.live()))
                if cfg.lag_probe_every and self.alive \
                        and (w + 1) % cfg.lag_probe_every == 0:
                    # probe an add that SURVIVED its own delta (a
                    # backspaced value legitimately never appears)
                    self._lag_probe(served.get("name"),
                                    self.val_by_ts[self.alive[-1]],
                                    t_ack)
        except Exception as e:      # noqa: BLE001 — harness boundary
            self.errors.append(repr(e))


def run_fleet(cfg: Optional[LoadgenConfig] = None) -> Dict[str, Any]:
    """One oracle-checked closed-loop run against an in-process
    replica fleet.  Returns the fleet report (headline: distinct
    acked leaves/sec, reader p99 on non-primary replicas, anti-entropy
    lag p50/p99, oracle verdict, kill/failover outcome)."""
    from ..ops import merge
    cfg = cfg or LoadgenConfig(n_servers=3)
    assert cfg.n_servers >= 2, "fleet mode needs n_servers >= 2"
    merge.resolve_device(cfg.device)   # raises before a server is built
    oracle = oracle_mod.SessionOracle()
    h = _FleetHarness(cfg, oracle)
    for i in range(cfg.n_servers):
        h.spawn(f"n{i}")
    h.wait_ring_stable()
    sessions = [_FleetSession(h, i) for i in range(cfg.n_sessions)]
    t_start = time.perf_counter()
    giant_thread = killer_thread = None
    giant_state: Dict[str, Any] = {}
    try:
        for s in sessions:
            s.start()
        if cfg.giant_ops:
            giant_thread = threading.Thread(
                target=_fleet_giant, args=(h, giant_state), daemon=True)
            giant_thread.start()
        if cfg.kill_mid_run:
            killer_thread = threading.Thread(
                target=_fleet_killer, args=(h, giant_state),
                daemon=True)
            killer_thread.start()
        for s in sessions:
            s.join(600)
        if giant_thread is not None:
            giant_thread.join(600)
        if killer_thread is not None:
            killer_thread.join(600)
        load_wall_s = time.perf_counter() - t_start
        report = _fleet_quiesce(h, sessions, giant_state, load_wall_s)
    finally:
        for fs in h.live():
            try:
                fs.stop()
            except Exception:   # noqa: BLE001 — teardown boundary
                pass
        h.close_pools()
    return report


def _fleet_giant(h: _FleetHarness, state: Dict[str, Any]) -> None:
    """The giant-merge racer, fleet flavor: a chunk-spanning push on
    doc load0 whose primary the killer crashes mid-merge; the giant
    survives by retrying (429 AND failover 503/connection loss) until
    a surviving primary acks it — CRDT idempotence makes the retry
    safe even if the dead primary had partially merged it."""
    cfg = h.cfg
    sid = "fsess-giant"
    try:
        fs = h.live()[0]
        resp, raw = h.request(fs, "POST", "/docs/load0/replicas")
        rid = json.loads(raw)["replica"]
        ops, prev = [], 0
        for i in range(cfg.giant_ops):
            ts = rid * OFFSET + i + 1
            ops.append(Add(ts, (prev,), i % 997))
            prev = ts
        body = json_codec.dumps(Batch(tuple(ops)))
        state["primary"] = h.primary_name("load0")
        state["armed"] = True             # the killer may fire now
        deadline = time.monotonic() + 600
        attempt = 0
        t0 = time.perf_counter()
        while time.monotonic() < deadline:
            entry = [s for s in h.live()
                     if s.name != state.get("primary")] or h.live()
            fs = entry[attempt % len(entry)]
            attempt += 1
            try:
                resp, raw = h.request(
                    fs, "POST", "/docs/load0/ops", body=body,
                    headers={TRACE_HEADER: f"giant-fleet-{attempt:03d}",
                             SESSION_HEADER: sid}, timeout=600,
                    chaos_src=sid)
            except (OSError, HTTPException):
                time.sleep(0.2)
                continue
            if resp.status == 429:
                time.sleep(min(float(
                    resp.getheader("Retry-After") or 1), 0.1))
                continue
            if resp.status == 503:
                time.sleep(min(float(
                    resp.getheader("Retry-After") or 1), 0.5))
                continue
            out = json.loads(raw)
            if resp.status == 200 and out.get("accepted"):
                state["acked_s"] = round(time.perf_counter() - t0, 3)
                state["served_by"] = out.get("served_by")
                served = out.get("served_by") or {}
                h.oracle.observe_write_ack(
                    sid, f"load0@{served.get('name')}."
                         f"{served.get('epoch')}", out["trace_id"])
                return
            h.errors.append(f"giant -> {resp.status}")
            return
        h.errors.append("giant never acked")
    except Exception as e:          # noqa: BLE001 — harness boundary
        h.errors.append(f"giant: {e!r}")


def _fleet_killer(h: _FleetHarness, giant_state: Dict[str, Any]
                  ) -> None:
    """Crash the giant doc's primary mid-merge (after the giant is in
    flight), wait out failover, then — when configured — restart the
    server under its old name and record the bumped fencing epoch."""
    cfg = h.cfg
    try:
        deadline = time.monotonic() + 120
        while not giant_state.get("armed"):
            if time.monotonic() > deadline:
                h.errors.append("killer: giant never armed")
                return
            time.sleep(0.01)
        victim = giant_state.get("primary") or h.live()[0].name
        # let the giant land in the victim's queue / start merging
        time.sleep(0.3)
        t_kill = time.monotonic()
        h.crash(victim)
        h.kill_report["victim"] = victim
        # wait until routing actually failed over (lease TTL)
        while h.primary_name("load0") in (victim, None):
            if time.monotonic() - t_kill > 60:
                h.errors.append("failover never happened")
                return
            time.sleep(0.05)
        h.kill_report["failover_s"] = round(
            time.monotonic() - t_kill, 3)
        if cfg.restart_killed:
            # rejoin under the SAME name: crash-safe re-acquisition
            # bumps the fencing token; anti-entropy refills the state
            fs = h.spawn(victim)
            h.kill_report["rejoined_epoch"] = fs.node.epoch()
            with h.lock:
                h.dead.remove(victim)
    except Exception as e:          # noqa: BLE001 — harness boundary
        h.errors.append(f"killer: {e!r}")


def _fleet_quiesce(h: _FleetHarness, sessions, giant_state,
                   load_wall_s: float) -> Dict[str, Any]:
    cfg = h.cfg
    # drain every live engine, then wait for anti-entropy convergence
    # (fingerprint-equal snapshots on every replica, per doc)
    for fs in h.live():
        fs.node.engine.flush(timeout=120)
    docs = sorted({s.doc for s in sessions}
                  | ({"load0"} if cfg.giant_ops else set()))
    deadline = time.monotonic() + 120
    converged: Dict[str, str] = {}
    while time.monotonic() < deadline:
        fps: Dict[str, set] = {}
        ok = True
        for doc in docs:
            seen = set()
            for fs in h.live():
                try:
                    resp, _ = h.request(fs, "GET", f"/docs/{doc}")
                except (OSError, HTTPException):
                    ok = False
                    continue
                if resp.status != 200:
                    ok = False
                    continue
                seen.add(resp.getheader("X-State-Fingerprint"))
            fps[doc] = seen
            ok = ok and len(seen) == 1
        if ok:
            converged = {d: next(iter(s)) for d, s in fps.items()}
            break
        time.sleep(0.1)
    else:
        h.errors.append(f"fleet never converged: { {d: sorted(s) for d, s in fps.items()} }")
    # final reads: every session reads its doc from EVERY replica
    # (convergence across sessions per replica), and every replica's
    # state fingerprint feeds the cross-replica convergence check
    for s in sessions:
        for fs in h.live():
            s._read_via(fs, final=True)
    for doc in docs:
        for fs in h.live():
            try:
                resp, _ = h.request(fs, "GET", f"/docs/{doc}")
            except (OSError, HTTPException):
                continue
            if resp.status == 200:
                h.oracle.observe_replica_state(
                    doc, f"{fs.name}.{resp.getheader('X-Replica-Epoch')}",
                    resp.getheader("X-State-Fingerprint"))
    # acked-value durability: every value a session ever got acked must
    # be in the converged state (the sessions re-push through survivors
    # on primary death, so a kill may delay but never lose them)
    for doc in docs:
        fs = h.live()[0]
        try:
            resp, raw = h.request(fs, "GET", f"/docs/{doc}")
            served = set(json.loads(raw).get("values", []))
        except (OSError, HTTPException):
            served = set()
        for s in sessions:
            if s.doc != doc:
                continue
            missing = [v for v in s.surviving_values()
                       if v not in served]
            if missing:
                h.errors.append(
                    f"{s.sid}: acked values missing after "
                    f"convergence: {missing[:3]}")
    # the scrape surface must hold on a fleet member, cluster families
    # included, under the strict naming contract
    resp, raw = h.request(h.live()[0], "GET", "/metrics/prom")
    fams = prom_mod.parse_text(raw.decode())
    violations = h.oracle.finalize()

    def _pct(sorted_vals, q):
        return round(sorted_vals[min(len(sorted_vals) - 1,
                                     (q * len(sorted_vals)) // 100)], 4) \
            if sorted_vals else None

    lag = sorted(h.lag_s)
    rp = sorted(h.read_ms_primary)
    rr = sorted(h.read_ms_replica)
    errors = [e for s in sessions for e in s.errors] + h.errors
    per_server = {fs.name: {
        "ops_merged": sum(d.ops_merged for d in fs.node.engine.docs()),
        "node_id": fs.node.node_id(), "epoch": fs.node.epoch(),
        "antientropy": fs.node.antientropy.stats()["rounds"],
        # pooled inter-node links: anti-entropy/forward/
        # repair reuse, with chaos-poisoned evictions counted
        "connpool": fs.node.pool.stats(),
        "readcache": _aggregate_readcache(fs.node.engine),
        # watch fan-out: each member's registries — a
        # watcher on a non-primary is served LOCAL generations, so
        # its deliveries land here, not on the primary
        "watch": _aggregate_watch(fs.node.engine),
    } for fs in h.live()}
    leaves = sum(s.leaves_acked for s in sessions) \
        + (cfg.giant_ops if cfg.giant_ops and "acked_s" in giant_state
           else 0)
    ost = h.oracle.stats()
    # write-to-visibility ledger + canary: each member's per-stage lag
    # histograms and canary probe record
    visibility = {fs.name: {
        "ledger": fs.node.ledger.stats()
        if getattr(fs.node, "ledger", None) is not None else None,
        "canary": fs.node.canary.stats()
        if getattr(fs.node, "canary", None) is not None else None,
    } for fs in h.live()}
    return {
        "harness": "loadgen-fleet",
        "servers": cfg.n_servers,
        "sessions": cfg.n_sessions,
        "docs": cfg.n_docs,
        "writes_acked": sum(s.writes_acked for s in sessions),
        "leaves_acked": leaves,
        "load_wall_s": round(load_wall_s, 3),
        "ops_per_sec": round(leaves / load_wall_s, 1),
        "shed_429": sum(s.shed_429 for s in sessions),
        "retry_409": sum(s.retry_409 for s in sessions),
        "read_refused_503": sum(s.read_refused_503 for s in sessions),
        "reads_primary": len(rp),
        "reads_replica": len(rr),
        "read_primary_p50_ms": _pct(rp, 50),
        "read_primary_p99_ms": _pct(rp, 99),
        "read_replica_p50_ms": _pct(rr, 50),
        "read_replica_p99_ms": _pct(rr, 99),
        "lag_probes": len(lag),
        "lag_censored": h.lag_censored,
        "lag_p50_s": _pct(lag, 50),
        "lag_p99_s": _pct(lag, 99),
        "lag_max_s": round(lag[-1], 4) if lag else None,
        "giant": giant_state or None,
        "kill": h.kill_report or None,
        "converged": converged,
        "per_server": per_server,
        "connpool_clients": {
            "clean": h.pool.stats(),
            "chaos": h.chaos_pool.stats()
            if h.chaos_pool is not None else None},
        "oracle": ost,
        "violations": violations,
        "visibility": visibility,
        "prom_cluster_families": sorted(
            f for f in fams if f.startswith("crdt_cluster_")),
        # the replay line + fired-fault counters of the armed network
        # fault plan (None = clean links)
        "netchaos": h.netchaos.stats() if h.netchaos is not None
        else None,
        "netchaos_replay": h.netchaos.describe()
        if h.netchaos is not None else None,
        "errors": errors[:12],
    }


def main(argv) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m crdt_graph_tpu_torch.bench.loadgen",
        description="Closed-loop oracle-checked sessions against a "
                    "server (or, with --fleet, a three-node fleet).")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--fleet", action="store_true")
    ap.add_argument("sessions", nargs="?", type=int)
    ap.add_argument("writes", nargs="?", type=int)
    opts = ap.parse_args(argv)
    cfg = LoadgenConfig(device=opts.device)
    if opts.sessions is not None:
        cfg.n_sessions = opts.sessions
    if opts.writes is not None:
        cfg.writes_per_session = opts.writes
    if opts.fleet:
        cfg.n_servers = max(cfg.n_servers, 3)
        print(json.dumps(run_fleet(cfg)), flush=True)
        return
    print(json.dumps(run(cfg)), flush=True)


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
