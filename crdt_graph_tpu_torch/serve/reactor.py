"""Reactor egress: selector-parked watch delivery.

The fan-out tier (serve/watch.py) made a publish cost one encode
shared by every watcher — but each parked watcher still pinned a
``ThreadingHTTPServer`` handler thread, so the watchers-per-host
ceiling was the thread count, not the cached bytes.  This module is the missing delivery tier: an
event loop on :mod:`selectors` (epoll on Linux) that takes OWNERSHIP of
a parked watch connection's raw socket from its handler thread and
returns the thread to the pool.  Delivery cost per subscriber becomes
O(bytes written), not O(thread): 10,000+ watchers park on one host
behind one (configurably few, capped at 4) reactor thread.

Division of labor with the handler (service/http.py):

- **The handler keeps everything request-shaped**: parsing, admission
  (429 past ``GRAFT_WATCH_MAX``), the bounded-staleness 503 gate, and
  the resume walk — a watcher that is *behind* is served immediately by
  the thread, exactly as before.  Only a CAUGHT-UP connection detaches:
  the handler flushes its buffered writer, tells the server to skip the
  socket teardown (``ServingHTTPServer.note_detached``), and hands the
  socket object here with its resume mark, park deadline, and session
  identity.  The handler thread then exits back to the pool.
- **The reactor does everything a parked watcher needs**: publish
  notify fan-out via non-blocking writes of the single-flight cached
  window bytes (one encode per generation — the readcache counters
  stay the proof: misses +1, hits +(N-1)); per-connection bounded
  egress buffers with partial-write continuation (``EVENT_WRITE``
  re-arm); slow-consumer shed with the honest ``X-Watch-Resume-Since``
  handoff; park-budget heartbeats off a timing wheel; dead-connection
  reaping via read-EOF (``MSG_PEEK`` — pipelined request bytes are
  never consumed) instead of delivery-time discovery; SSE streams
  across generations with ``: hb`` keepalives; and 503/``event:
  closed`` named closes when the engine shuts down.

Wire contract: **byte-identical to a handler-thread response** (modulo
the ``Date`` header's timestamp).  The response head replicates
``BaseHTTPRequestHandler``'s exact header order, the delivery headers
come from the ONE shared builder (``serve.watch.delivery_headers``),
the body is the same cached window memoryview, and the
``X-Watch-Event`` taxonomy (notify/shed/timeout/closed) and 429/503
semantics are the handler's.

Keep-alive: after a long-poll delivery completes, the connection stays
reactor-owned in an *await-request* state (no watch slot held, no
thread).  When the client's next request arrives, the socket is
re-injected into the server (``process_request``) — a transient
handler thread parses it, and if it is another caught-up watch it
detaches right back.  Idle keep-alive costs one selector registration,
never a thread.

Buffer lifetime (the publish-swap rule): every queued write pins both
the body buffer (the memoryview itself) and the serving
``DocSnapshot`` (``conn`` holds it until the write drains), so a
publish that swaps the pointer can never tear an in-flight response.

Observability: ``crdt_reactor_*`` prom families (obs/prom.py) — parked
gauge, loop iterations, wakeups, partial-write continuations, egress
buffer bytes/high-water, sheds by reason, timing-wheel depth, reaps,
re-injections.
"""
from __future__ import annotations

import collections
import email.utils
import json
import os
import selectors
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler as _BaseHandler
from typing import Any, Deque, Dict, List, Optional, Set, Tuple

from ..obs.trace import WATCH_EVENT_HEADER, WATCH_RESUME_HEADER
from ..codec.packed import EMPTY_BATCH_BYTES
from . import watch as watch_mod

# reactor thread budget (GRAFT_REACTOR_THREADS): the whole point is a
# FLAT thread count, so the cap is hard — 10k watchers on <= 4 loops
DEFAULT_THREADS = 1
MAX_THREADS = 4

# per-connection egress buffer cap (GRAFT_REACTOR_BUF): an SSE consumer
# whose pending bytes exceed it is shed with the honest resume mark
# instead of buffering without bound (long-poll buffers are inherently
# one response deep)
DEFAULT_BUF_CAP = 1 << 20

# timing-wheel granularity: heartbeat/park deadlines quantize to this —
# a timer fires within [deadline, deadline + tick), never early (the
# handler's budget is also "at or after")
DEFAULT_TICK_S = 0.05

_CLOSED_BODY = json.dumps({"error": "engine shutting down"}).encode()

# the response head replicates the handler's wire exactly:
# status line, Server:, Date:, Content-Type:, Content-Length:, then the
# delivery headers in builder order, then Connection: close if owed
_SERVER_VERSION = "%s %s" % (_BaseHandler.server_version,
                             _BaseHandler.sys_version)


def render_head(code: int, length: int, hdrs: Optional[Dict[str, str]],
                close: bool, ctype: str = "application/json") -> bytes:
    """One response head, byte-compatible with what
    ``BaseHTTPRequestHandler.send_response`` + the handler's
    ``_send_raw`` emit (modulo the Date timestamp)."""
    try:
        phrase = _BaseHandler.responses[code][0]
    except KeyError:
        phrase = ""
    lines = ["HTTP/1.1 %d %s" % (code, phrase),
             "Server: " + _SERVER_VERSION,
             "Date: " + email.utils.formatdate(time.time(), usegmt=True),
             "Content-Type: " + ctype,
             "Content-Length: %d" % length]
    for k, v in (hdrs or {}).items():
        lines.append("%s: %s" % (k, v))
    if close:
        lines.append("Connection: close")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class ReactorStats:
    """Reactor-wide counters/gauges (thread-safe adds; gauges are
    maintained by the loops and read racily — they are monitoring, not
    accounting)."""

    FIELDS = ("detached", "loops", "wakeups", "notified", "partial_writes",
              "sheds_buffer", "reaps", "reinjects", "timers_fired",
              "closes")

    def __init__(self):
        self._mu = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)
        self.parked_peak = 0
        self.buf_hw = 0       # egress-buffer high water, bytes

    def add(self, field: str, n: int = 1) -> None:
        with self._mu:
            setattr(self, field, getattr(self, field) + n)

    def peak(self, field: str, v: int) -> None:
        with self._mu:
            if v > getattr(self, field):
                setattr(self, field, v)

    def snapshot(self) -> Dict[str, int]:
        with self._mu:
            out = {f: getattr(self, f) for f in self.FIELDS}
            out["parked_peak"] = self.parked_peak
            out["buf_hw"] = self.buf_hw
            return out


class _Conn:
    """One reactor-owned connection.  States:

    - ``parked``  — holding a watch slot, waiting on notify/timer
      (long-poll) or streaming-idle (SSE); EVENT_READ armed for EOF
      reap via MSG_PEEK.
    - ``writing`` — response/event bytes queued; EVENT_WRITE armed on
      EAGAIN, continuation resumes where the last send stopped.
    - ``await``   — long-poll delivery done, slot released, keep-alive
      honored: EVENT_READ armed; the next request re-injects the
      socket into the server.
    """

    __slots__ = ("sock", "addr", "fd", "store", "doc", "reg", "mode",
                 "since", "limit", "deadline", "hb_deadline",
                 "parked_seq", "session", "keep_alive", "state", "out",
                 "pins", "slot_held", "close_after", "events",
                 "wheel_slot", "notify_at")

    def __init__(self, sock, addr, store, doc, reg, mode, since, limit,
                 deadline, parked_seq, session, keep_alive,
                 hb_deadline=None):
        self.sock = sock
        self.addr = addr
        self.fd = sock.fileno()
        self.store = store
        self.doc = doc
        self.reg = reg
        self.mode = mode              # "poll" | "sse"
        self.since = since
        self.limit = limit
        self.deadline = deadline      # park/stream budget (monotonic)
        self.hb_deadline = hb_deadline   # SSE keepalive timer
        self.parked_seq = parked_seq  # seq the watcher is caught up to
        self.session = session
        self.keep_alive = keep_alive
        self.state = "parked"
        self.out: Deque[memoryview] = collections.deque()
        self.pins: List[Any] = []     # snapshots pinned by queued writes
        self.slot_held = True         # registry slot owned until release
        self.close_after = False      # close socket once `out` drains
        self.events = 0               # selector interest currently armed
        self.wheel_slot: Optional[int] = None
        self.notify_at: Optional[float] = None

    def pending(self) -> int:
        return sum(len(m) for m in self.out)


class _Loop(threading.Thread):
    """One reactor thread: a selector, a wakeup pipe, a command queue,
    and a coarse timing wheel.  All connection state is owned by this
    thread — other threads only ``submit()``."""

    def __init__(self, reactor: "Reactor", idx: int):
        super().__init__(name=f"graft-reactor-{idx}", daemon=True)
        self.reactor = reactor
        self.sel = selectors.DefaultSelector()
        self._rwake, self._wwake = os.pipe()
        os.set_blocking(self._rwake, False)
        self.sel.register(self._rwake, selectors.EVENT_READ, None)
        self._cmds: Deque[Tuple] = collections.deque()
        self._cmd_mu = threading.Lock()
        self._signaled = False
        self._conns: Dict[int, _Conn] = {}
        self._by_reg: Dict[int, Set[_Conn]] = {}
        self._tick = reactor.tick_s
        self._wheel: Dict[int, Set[_Conn]] = {}
        self.parked = 0          # slot-holding conns (gauge)
        self.buf_bytes = 0       # queued egress bytes (gauge)
        self.timer_depth = 0     # wheel entries (gauge)
        self._stopping = False
        self._stop_at: Optional[float] = None

    # -- cross-thread entry ------------------------------------------------

    def submit(self, cmd: Tuple) -> None:
        with self._cmd_mu:
            self._cmds.append(cmd)
            if self._signaled:
                return
            self._signaled = True
        try:
            os.write(self._wwake, b"x")
        except OSError:
            pass

    # -- loop body ---------------------------------------------------------

    def run(self) -> None:
        try:
            self._run()
        finally:
            for conn in list(self._conns.values()):
                self._drop(conn)
            try:
                self.sel.close()
            except OSError:
                pass
            for fd in (self._rwake, self._wwake):
                try:
                    os.close(fd)
                except OSError:
                    pass

    def _run(self) -> None:
        stats = self.reactor.stats
        while True:
            timeout = self._poll_timeout()
            try:
                events = self.sel.select(timeout)
            except OSError:
                events = []
            stats.add("loops")
            for key, mask in events:
                if key.data is None:            # wakeup pipe
                    try:
                        while os.read(self._rwake, 4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                    stats.add("wakeups")
                    continue
                conn = key.data
                if conn.fd not in self._conns:
                    continue                     # dropped this round
                if mask & selectors.EVENT_WRITE:
                    self._on_writable(conn)
                if mask & selectors.EVENT_READ \
                        and conn.fd in self._conns:
                    self._on_readable(conn)
            self._drain_cmds()
            self._fire_timers(time.monotonic())
            if self._stopping:
                if not self._conns:
                    return
                if self._stop_at is not None \
                        and time.monotonic() >= self._stop_at:
                    return                       # force-drop in finally

    def _poll_timeout(self) -> Optional[float]:
        with self._cmd_mu:
            if self._cmds:
                return 0.0
        if self._stopping:
            return 0.05
        if self._wheel:
            nxt = min(self._wheel) * self._tick
            return max(0.0, min(nxt - time.monotonic(), 1.0))
        # fully idle (or only await/writing conns): selector events and
        # the wakeup pipe are the only signals that matter
        return None if not self._conns else 1.0

    def _drain_cmds(self) -> None:
        while True:
            with self._cmd_mu:
                if not self._cmds:
                    self._signaled = False
                    return
                cmd = self._cmds.popleft()
            kind = cmd[0]
            if kind == "park":
                self._on_park(cmd[1])
            elif kind == "notify":
                _, reg, seq, at = cmd
                self._on_notify(reg, seq, at)
            elif kind == "close":
                self._on_close_registry(cmd[1])
            elif kind == "stop":
                self._stopping = True
                self._stop_at = time.monotonic() + 5.0

    # -- command handlers --------------------------------------------------

    def _on_park(self, conn: _Conn) -> None:
        self._conns[conn.fd] = conn
        self._by_reg.setdefault(id(conn.reg), set()).add(conn)
        conn.reg.note_reactor_park(+1)
        self.parked += 1
        self.reactor.stats.peak("parked_peak", self.reactor.parked())
        try:
            conn.sock.setblocking(False)
        except OSError:
            self._reap_dead(conn)
            return
        seq, pub_at, closed = conn.reg.published_state()
        if closed:
            self._deliver_closed(conn)
            return
        if seq > conn.parked_seq:
            # missed-wake window: a publish landed between the
            # handler's freshness check and this pickup
            self._deliver(conn, pub_at)
            return
        self._arm(conn, selectors.EVENT_READ)
        self._file_timer(conn)

    def _on_notify(self, reg, seq: int, at: float) -> None:
        conns = self._by_reg.get(id(reg))
        if not conns:
            return
        self.reactor.stats.add("notified", len(conns))
        for conn in list(conns):
            if conn.state == "parked" and seq > conn.parked_seq:
                self._deliver(conn, at)
            elif conn.state == "writing" and conn.mode == "sse":
                # in-flight event write: remember the generation moved;
                # the write-complete hook re-pumps the stream
                conn.notify_at = at

    def _on_close_registry(self, reg) -> None:
        for conn in list(self._by_reg.get(id(reg), ())):
            if conn.slot_held and conn.state in ("parked", "writing"):
                self._deliver_closed(conn)

    # -- timers ------------------------------------------------------------

    def _file_timer(self, conn: _Conn) -> None:
        dl = conn.deadline
        if conn.mode == "sse" and conn.hb_deadline is not None:
            dl = min(dl, conn.hb_deadline)
        slot = int(dl / self._tick)
        conn.wheel_slot = slot
        self._wheel.setdefault(slot, set()).add(conn)
        self.timer_depth += 1

    def _cancel_timer(self, conn: _Conn) -> None:
        slot = conn.wheel_slot
        if slot is None:
            return
        conn.wheel_slot = None
        bucket = self._wheel.get(slot)
        if bucket is not None and conn in bucket:
            bucket.discard(conn)
            self.timer_depth -= 1
            if not bucket:
                self._wheel.pop(slot, None)

    def _fire_timers(self, now: float) -> None:
        if not self._wheel:
            return
        cur = int(now / self._tick)
        for slot in [s for s in self._wheel if s <= cur]:
            for conn in list(self._wheel.get(slot, ())):
                dl = conn.deadline
                if conn.mode == "sse" and conn.hb_deadline is not None:
                    dl = min(dl, conn.hb_deadline)
                if dl > now:
                    # coarse-wheel re-file: never fire EARLY
                    self._cancel_timer(conn)
                    conn.wheel_slot = slot + 1
                    self._wheel.setdefault(slot + 1, set()).add(conn)
                    self.timer_depth += 1
                    continue
                self._cancel_timer(conn)
                self.reactor.stats.add("timers_fired")
                self._on_timer(conn, now)

    def _on_timer(self, conn: _Conn, now: float) -> None:
        if conn.state != "parked":
            return
        seq, pub_at, closed = conn.reg.published_state()
        if closed:
            self._deliver_closed(conn)
            return
        if seq > conn.parked_seq:
            # the publish beat the timer to this iteration: it wins
            # over the timeout
            self._deliver(conn, pub_at)
            return
        if conn.mode == "sse":
            if now >= conn.deadline:
                # stream budget: named goodbye with the resume mark
                self._enqueue(conn,
                              b"event: bye\ndata: "
                              b'{"resume_since": %d}\n\n' % conn.since)
                conn.close_after = True
                self._release_slot(conn)
                self._flush(conn)
                return
            conn.reg.stats.add("heartbeats")
            self._enqueue(conn, b": hb\n\n")
            conn.hb_deadline = now + max(0.05, conn.reg.heartbeat_s)
            self._flush(conn)
            if conn.state == "parked":
                self._file_timer(conn)
            return
        # long-poll park budget: the empty heartbeat batch, stamped
        # with the caught-up window's ETag for the next poll's
        # If-None-Match — byte-identical to the handler's zero-budget
        # timeout
        snap = conn.doc.snapshot_view()
        body, meta, pin = snap.pinned_window(conn.since, conn.limit)
        hdrs = watch_mod.delivery_headers(conn.store, snap, meta,
                                          conn.since, conn.session)
        hdrs[WATCH_EVENT_HEADER] = "timeout"
        conn.reg.stats.add("heartbeats")
        head = render_head(200, len(EMPTY_BATCH_BYTES), hdrs,
                           close=not conn.keep_alive)
        conn.state = "writing"
        self._enqueue(conn, head, EMPTY_BATCH_BYTES, pin=pin)
        if not conn.keep_alive:
            conn.close_after = True
        self._flush(conn)

    # -- delivery ----------------------------------------------------------

    def _deliver(self, conn: _Conn, published_at: float) -> None:
        """A generation moved past the parked mark: ship it.  Event
        taxonomy: ``notify`` (latency from
        the pointer swap), overridden by ``shed`` + resume mark when
        the watcher is more than one window behind."""
        self._cancel_timer(conn)
        if conn.mode == "sse":
            self._sse_pump(conn, published_at)
            return
        snap = conn.doc.snapshot_view()
        body, meta, pin = snap.pinned_window(conn.since, conn.limit)
        reg = conn.reg
        hdrs = watch_mod.delivery_headers(conn.store, snap, meta,
                                          conn.since, conn.session)
        reg.stats.observe_notify(
            (time.perf_counter() - published_at) * 1e3)
        hdrs[WATCH_EVENT_HEADER] = "notify"
        if meta["more"]:
            reg.stats.add("shed_slow")
            hdrs[WATCH_EVENT_HEADER] = "shed"
            hdrs[WATCH_RESUME_HEADER] = str(meta["next_since"])
        head = render_head(200, len(body), hdrs,
                           close=not conn.keep_alive)
        conn.state = "writing"
        self._enqueue(conn, head, body, pin=pin)
        if not conn.keep_alive:
            conn.close_after = True
        self._flush(conn)

    def _sse_pump(self, conn: _Conn, published_at: Optional[float]) -> None:
        """Emit every window the stream is missing (one ``ops`` event
        per window, advancing the mark), exactly as the handler's SSE
        loop does; stop on caught-up, reset, shed, or a full egress
        buffer (reactor-specific shed — the honest alternative to
        unbounded buffering)."""
        self._cancel_timer(conn)
        reg, doc = conn.reg, conn.doc
        first = True
        while True:
            snap = doc.snapshot_view()
            body, meta, pin = snap.pinned_window(conn.since, conn.limit)
            fresh = watch_mod.watch_fresh(meta, conn.since) or \
                snap.seq > conn.parked_seq
            conn.parked_seq = snap.seq
            if not fresh:
                break
            if first and published_at is not None:
                reg.stats.observe_notify(
                    (time.perf_counter() - published_at) * 1e3)
                first = False
            ev = bytearray(b"event: ops\n")
            if meta["next_since"] is not None:
                ev += b"id: %d\n" % meta["next_since"]
            for line in bytes(body).split(b"\n"):
                ev += b"data: " + line + b"\n"
            ev += b"\n"
            self._enqueue(conn, bytes(ev), pin=pin)
            if not meta["found"]:
                self._enqueue(conn, b"event: reset\ndata: {}\n\n")
                conn.close_after = True
                self._release_slot(conn)
                break
            if meta["next_since"] is not None:
                conn.since = meta["next_since"]
            if meta["more"]:
                reg.stats.add("shed_slow")
                self._enqueue(conn,
                              b"event: shed\ndata: "
                              b'{"resume_since": %d}\n\n' % conn.since)
                conn.close_after = True
                self._release_slot(conn)
                break
            if self.buf_bytes_of(conn) > self.reactor.buf_cap:
                # bounded egress: this consumer cannot keep up with
                # its own stream — shed with the exact resume mark
                reg.stats.add("shed_slow")
                self.reactor.stats.add("sheds_buffer")
                self._enqueue(conn,
                              b"event: shed\ndata: "
                              b'{"resume_since": %d}\n\n' % conn.since)
                conn.close_after = True
                self._release_slot(conn)
                break
        conn.notify_at = None
        if conn.slot_held and conn.out:
            conn.state = "writing"
        self._flush(conn)
        if conn.state == "parked":
            conn.hb_deadline = time.monotonic() + max(
                0.05, reg.heartbeat_s)
            self._file_timer(conn)

    def _deliver_closed(self, conn: _Conn) -> None:
        """Engine shutdown: the same named close the handler writes
        when the reactor is stopped — 503 + ``X-Watch-Event: closed`` (long-poll) or
        ``event: closed`` (SSE) — then the socket closes."""
        self._cancel_timer(conn)
        self.reactor.stats.add("closes")
        if conn.mode == "sse":
            self._enqueue(conn, b"event: closed\ndata: {}\n\n")
        else:
            head = render_head(503, len(_CLOSED_BODY),
                               {WATCH_EVENT_HEADER: "closed"},
                               close=False)
            self._enqueue(conn, head, _CLOSED_BODY)
        conn.state = "writing"
        conn.close_after = True
        self._release_slot(conn)
        self._flush(conn)

    # -- socket plumbing ---------------------------------------------------

    def buf_bytes_of(self, conn: _Conn) -> int:
        return conn.pending()

    def _enqueue(self, conn: _Conn, *bufs, pin=None) -> None:
        for b in bufs:
            mv = b if isinstance(b, memoryview) else memoryview(b)
            if len(mv) == 0:
                continue
            conn.out.append(mv)
            self.buf_bytes += len(mv)
        if pin is not None:
            # publish-swap safety: the snapshot stays referenced until
            # the write drains — a swap cannot tear the in-flight body
            conn.pins.append(pin)
        self.reactor.stats.peak("buf_hw", self.buf_bytes)

    def _flush(self, conn: _Conn) -> None:
        while conn.out:
            mv = conn.out[0]
            try:
                n = conn.sock.send(mv)
            except (BlockingIOError, InterruptedError):
                self.reactor.stats.add("partial_writes")
                self._arm(conn, conn.events | selectors.EVENT_WRITE)
                return
            except OSError:
                self._reap_dead(conn)
                return
            self.buf_bytes -= n
            if n < len(mv):
                conn.out[0] = mv[n:]
                self.reactor.stats.add("partial_writes")
                self._arm(conn, conn.events | selectors.EVENT_WRITE)
                return
            conn.out.popleft()
        self._write_complete(conn)

    def _write_complete(self, conn: _Conn) -> None:
        conn.pins.clear()
        if conn.close_after:
            self._drop(conn)
            return
        if conn.mode == "sse":
            conn.state = "parked"
            if conn.notify_at is not None:
                at, conn.notify_at = conn.notify_at, None
                self._sse_pump(conn, at)
                return
            self._arm(conn, selectors.EVENT_READ)
            if conn.wheel_slot is None:
                self._file_timer(conn)
            return
        if conn.state == "writing":
            # a long-poll response went out: the watch request is
            # DONE — release the slot like the handler's finally would
            self._release_slot(conn)
            conn.state = "await"
            self._arm(conn, selectors.EVENT_READ)

    def _on_writable(self, conn: _Conn) -> None:
        self._arm(conn, conn.events & ~selectors.EVENT_WRITE)
        self._flush(conn)

    def _on_readable(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(1, socket.MSG_PEEK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._reap_dead(conn)
            return
        if not data:
            # client EOF: reap here, not at the next delivery write
            self._reap_dead(conn)
            return
        if conn.state == "await":
            self._reinject(conn)
        else:
            # bytes while parked (a pipelined request): stop watching
            # READ — the bytes stay unconsumed in the kernel buffer
            # and replay intact at re-injection; EOF-reap is lost for
            # this conn but the park budget still bounds its slot
            self._arm(conn, conn.events & ~selectors.EVENT_READ)

    def _reinject(self, conn: _Conn) -> None:
        """The keep-alive client spoke again: hand the socket back to
        the server — a transient handler thread parses the request
        (any route) and a caught-up watch detaches right back."""
        self._detach_from_loop(conn)
        server = self.reactor.server
        if server is None:
            try:
                conn.sock.close()
            except OSError:
                pass
            return
        self.reactor.stats.add("reinjects")
        try:
            conn.sock.setblocking(True)
            server.process_request(conn.sock, conn.addr)
        except OSError:
            try:
                conn.sock.close()
            except OSError:
                pass

    def _reap_dead(self, conn: _Conn) -> None:
        if conn.slot_held:
            conn.reg.stats.add("reaped")
            self.reactor.stats.add("reaps")
        self._drop(conn)

    def _release_slot(self, conn: _Conn) -> None:
        if not conn.slot_held:
            return
        conn.slot_held = False
        conn.reg.note_reactor_park(-1)
        conn.reg.unregister()
        self.parked -= 1
        bucket = self._by_reg.get(id(conn.reg))
        if bucket is not None:
            bucket.discard(conn)
            if not bucket:
                self._by_reg.pop(id(conn.reg), None)

    def _drop(self, conn: _Conn) -> None:
        self._cancel_timer(conn)
        self.buf_bytes -= conn.pending()
        conn.out.clear()
        conn.pins.clear()
        self._release_slot(conn)
        self._detach_from_loop(conn)
        try:
            conn.sock.close()
        except OSError:
            pass

    def _detach_from_loop(self, conn: _Conn) -> None:
        if conn.events:
            try:
                self.sel.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass
            conn.events = 0
        self._conns.pop(conn.fd, None)
        bucket = self._by_reg.get(id(conn.reg))
        if bucket is not None:
            bucket.discard(conn)

    def _arm(self, conn: _Conn, events: int) -> None:
        if events == conn.events:
            return
        try:
            if conn.events == 0 and events:
                self.sel.register(conn.sock, events, conn)
            elif events == 0:
                self.sel.unregister(conn.sock)
            else:
                self.sel.modify(conn.sock, events, conn)
            conn.events = events
        except (KeyError, ValueError, OSError):
            self._reap_dead(conn)


class Reactor:
    """The engine-owned delivery tier: N loops (``<= 4``), lazy-started
    at the first park so engines that never serve a watch never pay a
    thread.  Public API is thread-safe and O(loops) per call."""

    def __init__(self, threads: int = DEFAULT_THREADS,
                 buf_cap: int = DEFAULT_BUF_CAP,
                 tick_s: float = DEFAULT_TICK_S):
        self.n_threads = max(1, min(int(threads), MAX_THREADS))
        self.buf_cap = max(1 << 14, int(buf_cap))
        self.tick_s = float(tick_s)
        self.stats = ReactorStats()
        self.server = None          # attached by service.http.make_server
        self._mu = threading.Lock()
        self._loops: List[_Loop] = []
        self._started = False
        self._stopped = False

    # -- lifecycle ---------------------------------------------------------

    def ensure_started(self) -> bool:
        with self._mu:
            if self._stopped:
                return False
            if not self._started:
                self._loops = [_Loop(self, i)
                               for i in range(self.n_threads)]
                for lp in self._loops:
                    lp.start()
                self._started = True
            return True

    def stop(self, timeout: float = 10.0) -> None:
        """Drain and join: queued close commands (the registries were
        closed first) write their named 503/``event: closed`` bytes,
        then the loops exit.  Idempotent."""
        with self._mu:
            self._stopped = True
            loops, started = self._loops, self._started
            self._loops, self._started = [], False
        for lp in loops:
            lp.submit(("stop",))
        deadline = time.monotonic() + max(0.1, timeout)
        for lp in loops:
            lp.join(max(0.05, deadline - time.monotonic()))

    # -- handler-side ------------------------------------------------------

    def park(self, sock, addr, store, doc, reg, mode, since, limit,
             deadline, parked_seq, session, keep_alive,
             hb_deadline=None) -> bool:
        """Take ownership of a detached, caught-up watch connection.
        Returns False when the reactor is stopped (the caller closes
        the socket)."""
        if not self.ensure_started():
            return False
        conn = _Conn(sock, addr, store, doc, reg, mode, since, limit,
                     deadline, parked_seq, session, keep_alive,
                     hb_deadline=hb_deadline)
        self.stats.add("detached")
        loop = self._loops[conn.fd % len(self._loops)] \
            if self._loops else None
        if loop is None:
            return False
        loop.submit(("park", conn))
        return True

    # -- publisher-side ----------------------------------------------------

    def notify(self, reg, seq: int, published_at: float) -> None:
        with self._mu:
            loops = list(self._loops)
        for lp in loops:
            lp.submit(("notify", reg, seq, published_at))

    def close_registry(self, reg) -> None:
        with self._mu:
            loops = list(self._loops)
        for lp in loops:
            lp.submit(("close", reg))

    # -- observability -----------------------------------------------------

    def parked(self) -> int:
        with self._mu:
            loops = list(self._loops)
        return sum(lp.parked for lp in loops)

    def snapshot(self) -> Dict[str, Any]:
        with self._mu:
            loops = list(self._loops)
            started = self._started
        out = self.stats.snapshot()
        out.update({
            "threads": len(loops),
            "started": started,
            "parked": sum(lp.parked for lp in loops),
            "egress_buffer_bytes": sum(lp.buf_bytes for lp in loops),
            "timer_depth": sum(lp.timer_depth for lp in loops),
        })
        return out
