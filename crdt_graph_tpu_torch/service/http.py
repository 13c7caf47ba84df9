"""HTTP wire service speaking the reference JSON codec.

Endpoints (all JSON; the operation payloads are byte-compatible with the
reference codec, CRDTree/Operation.elm:109-159, so Elm clients — e.g. the
companion text editor — interoperate unmodified):

- ``POST /docs/{id}/replicas``         → ``{"replica": n}``  (coordinator
  role: unique numeric replica ids, README.md:20-22)
- ``POST /docs/{id}/ops``   body = op  → ``{"accepted": bool,
  "applied_count": n, "applied": op}`` (merge a delta; rejection =
  causality gap, client syncs and retries; ``applied`` is echoed only
  for deltas ≤ 4096 leaves — bootstrap-size pushes get the count)
- ``GET  /docs/{id}/ops?since=ts``     → op batch (pull anti-entropy,
  CRDTree.elm:390-418; served pre-encoded by the native column encoder)
- ``GET  /docs/{id}/snapshot``         → binary packed checkpoint (npz)
  — one-transfer bootstrap for big docs; claim an id via
  ``POST /replicas``, restore with
  ``TpuTree.restore_packed(io.BytesIO(body), replica=id)`` (the raw
  snapshot carries the SERVER's id), then catch up with ``/ops?since=``
- ``GET  /docs/{id}/clock``            → ``{"replicas": {rid: ts}}`` —
  the server's vector clock; pull ``/ops?since=clock[you]`` for exactly
  the missing suffix (server face of ``lastReplicaTimestamp``,
  CRDTree.elm:637-639)
- ``GET  /docs/{id}``                  → ``{"values": [...]}`` (visible doc)
- ``GET  /docs/{id}/watch?since=ts``   → delta-push fan-out
  (serve/watch.py; docs/SERVING.md §Watch & fan-out): long-poll
  (default; one ops window per response, parks until the next publish)
  or SSE (``mode=sse``; one ``ops`` event per generation on a single
  stream).  Bounded admission (429 past ``GRAFT_WATCH_MAX``),
  slow-consumer shed with ``X-Watch-Resume-Since``, heartbeats, and
  the bounded-staleness 503 gate ahead of parking.
- ``GET  /docs/{id}/metrics`` and ``GET /metrics`` → counters
- ``GET  /metrics/scheduler``          → serving-engine counters + spans
- ``GET  /metrics/prom``               → unified Prometheus-style text
  exposition (doc counters, scheduler histograms WITH bucket bounds,
  span registry, flight-recorder gauges — docs/OBSERVABILITY.md)
- ``GET  /debug/flight``               → flight-recorder ring as JSON
  (per-commit records: trace_ids, stage breakdown, fingerprints)

Write tracing: ``POST /docs/{id}/ops`` mints a ``trace_id`` at
admission (or adopts a well-formed ``X-Trace-Id`` request header),
threads it through the coalescing scheduler into the commit's flight
record, and echoes it in every response (body + ``X-Trace-Id``).

Read tracing: ``GET /docs/{id}`` and ``GET /docs/{id}/
snapshot`` resolve body AND headers against ONE snapshot view and echo
``X-Snapshot-Fingerprint`` + ``X-Commit-Seq`` (the served snapshot's
identity) plus an adopted-or-minted ``X-Session-Id`` — so reads are as
attributable as writes and a session-guarantee checker
(obs/oracle.py) can join every read to the commit stream.  Writes
echo a well-formed client ``X-Session-Id`` too.

Read-path egress (docs/SERVING.md §Read path & egress):
document and snapshot reads carry an ``ETag`` (the quoted
replica-independent state fingerprint) and honor ``If-None-Match`` —
an unchanged document answers ``304`` with the full correlation
header set (``X-Commit-Seq``/``X-Replica-*``/``X-Ae-Lag-Seconds``)
but no body; the bounded-staleness 503 gate runs FIRST, so a 304
never outranks the staleness contract.  200 bodies come from the
snapshot's per-generation encoded-body cache (serve/snapshot.py) and
ship as memoryviews — no per-request ``json.dumps`` or list copy.

Run: ``python -m crdt_graph_tpu_torch.service [port]`` (on the card) or
embed via ``serve(port)`` / ``make_server(port, device=...)``
(``device="cpu"`` runs the kernels' plain twins).

Concurrency design (serve/, docs/SERVING.md): reads and merges are
decoupled by the serving engine.  Every read endpoint (doc values,
``/ops?since=``, ``/clock``, ``/snapshot``, metrics) resolves against
the document's PUBLISHED IMMUTABLE SNAPSHOT — swapped in atomically on
each merge commit — so reads never take a merge lock and never stall
behind a large catch-up merge.  ``POST /ops`` parses the body in the
handler thread, enqueues the delta on the document's bounded merge
queue, and blocks until the scheduler thread has fused it (with every
other delta pending on that document, and with other documents' merges
in one batched launch when they coincide) and published the commit's
snapshot — so a client always reads its own writes.  Backpressure is
explicit: a full queue answers ``429`` with a ``Retry-After`` estimate
from the document's recent commit latency, without touching the tree;
giant pushes merge as bounded chunks so they cannot monopolize the
scheduler.  ``POST /ops`` bodies are capped (``max_body``, default
128 MB ≈ a 2M-op JSON batch) and oversized requests get 413 without
reading the body.  Passing an explicit ``DocumentStore`` to
``make_server`` keeps the legacy lock-per-document inline-merge path
(same wire contract).
"""
from __future__ import annotations

import json
import os
import re
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..codec.json_codec import DecodeError
from ..core.errors import CheckpointError
from ..obs import prom as prom_mod
from ..obs.trace import (AE_LAG_HEADER, AE_PEER_HEADER,
                         CATCHUP_REMAINING_HEADER,
                         COMMIT_SEQ_HEADER,
                         FORWARDED_HEADER, MAX_STALENESS_HEADER,
                         SESSION_HEADER,
                         SINCE_FOUND_HEADER, SINCE_MORE_HEADER,
                         SINCE_NEXT_HEADER, SNAP_FP_HEADER,
                         SPAN_CTX_HEADER, TRACE_FRONTIER_HEADER,
                         TRACE_HEADER, WATCH_EVENT_HEADER,
                         WATCH_RESUME_HEADER, ensure_session_id,
                         ensure_trace_id, is_valid_id)
from ..cluster.gateway import ForwardError
from ..oplog import EMPTY_BATCH_BYTES
from ..serve import (ECHO_LIMIT, QueueFull, SchedulerError,
                     SchedulerStopped, ServingEngine)
from ..serve import watch as watch_mod
from ..serve.watch import WatchClosed, WatchFull
from .store import DocumentStore

# default and ceiling for one watch request's ops window (leaves): a
# caught-up watcher population all asks for the same (since, limit), so
# ONE value here is what makes the generation's encode shared
DEFAULT_WATCH_LIMIT = 8192

_DOC = re.compile(r"^/docs/([A-Za-z0-9_.-]+)(/.*)?$")


def etag_matches(header: Optional[str], etag: str) -> bool:
    """Whether an ``If-None-Match`` header matches ``etag`` (the
    snapshot's quoted state fingerprint).  RFC 7232 weak-comparison
    shape: ``*`` matches anything, the list splits on commas, a ``W/``
    prefix is ignored.  Malformed members simply fail to match — a
    garbage header degrades to an unconditional GET, never an error."""
    if not header:
        return False
    if header.strip() == "*":
        return True
    for tok in header.split(","):
        tok = tok.strip()
        if tok.startswith("W/"):
            tok = tok[2:]
        if tok == etag:
            return True
    return False


DEFAULT_MAX_BODY = 128 << 20
# ECHO_LIMIT (serve/engine.py): applied-ops echo cap in leaves; above it
# the response carries the count only.  Imported, not redefined — the
# scheduler stops materializing echo objects at the same bound.


def make_handler(store: DocumentStore, max_body: int = DEFAULT_MAX_BODY):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):   # quiet by default
            pass

        def _send(self, code: int, payload, headers=None) -> None:
            self._send_raw(code, json.dumps(payload).encode(),
                           headers=headers)

        def _send_raw(self, code: int, body,
                      ctype: str = "application/json",
                      headers=None) -> None:
            """Ship one response.  ``body`` may be any buffer — cached
            snapshot bodies go out as a memoryview so a shared
            generation-wide ``bytes`` object is never copied per
            request.  A 304 carries its headers (the conditional-GET
            contract: seq/replica/lag stamps intact) but no body, and
            when the handler decided to close the connection the
            client is TOLD so (keep-alive pools must not discover it
            by a failed reuse)."""
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length",
                             "0" if code == 304 else str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            if self.close_connection:
                self.send_header("Connection", "close")
            self.end_headers()
            if code != 304 and len(body):
                self.wfile.write(body if isinstance(body, memoryview)
                                 else memoryview(body))

        def _serve_ops_plan(self, doc, plan) -> bool:
            """Ship a zero-copy ``/ops`` window (docs/SERVING.md
            §Zero-copy egress): the plan's literal pieces go out with
            ``sendall`` and its sidecar file ranges with
            ``os.sendfile`` straight from page cache to socket — the
            window body is never materialized in this process.  The
            bytes on the wire, the ``ETag``, the ``X-Since-*`` resume
            headers, and the 304 behavior are IDENTICAL to the
            buffered path.  Returns True when the response was handled
            (200, 304, or a died-mid-stream connection), False when
            the caller should fall back to buffered (a planned sidecar
            vanished before any byte was sent)."""
            chunks, total, meta, snap = plan
            hdrs = {
                SINCE_FOUND_HEADER: "1" if meta["found"] else "0",
                SINCE_MORE_HEADER: "1" if meta["more"] else "0",
            }
            if meta["next_since"] is not None:
                hdrs[SINCE_NEXT_HEADER] = str(meta["next_since"])
            hdrs["ETag"] = meta["etag"]
            # same frontier stamp as the buffered branch — the two
            # /ops paths must carry identical headers
            if hasattr(store, "trace_frontier_header"):
                tf = store.trace_frontier_header(
                    getattr(doc, "doc_id", None))
                if tf:
                    hdrs[TRACE_FRONTIER_HEADER] = tf
            if etag_matches(self.headers.get("If-None-Match"),
                            meta["etag"]):
                if hasattr(doc, "readcache"):
                    doc.readcache.served_304()
                self._send_raw(304, b"", headers=hdrs)
                return True
            sf = getattr(doc, "sendfile_stats", None)
            # open every planned file BEFORE the status line goes out:
            # an open failure here still has the buffered fallback
            fds: dict = {}
            try:
                for c in chunks:
                    if c[0] == "f" and c[1] not in fds:
                        fds[c[1]] = os.open(c[1], os.O_RDONLY)
            except OSError:
                for fd in fds.values():
                    os.close(fd)
                if sf is not None:
                    sf.add("fallback")
                return False
            try:
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(total))
                for k, v in hdrs.items():
                    self.send_header(k, v)
                if self.close_connection:
                    self.send_header("Connection", "close")
                self.end_headers()
                # drain the handler's buffered writer before touching
                # the raw socket — header bytes must precede body bytes
                self.wfile.flush()
                out = self.connection.fileno()
                file_bytes = 0
                for c in chunks:
                    if c[0] == "b":
                        self.connection.sendall(c[1])
                        continue
                    _, path, off, remaining = c
                    fd = fds[path]
                    while remaining:
                        sent = os.sendfile(out, fd, off, remaining)
                        if sent == 0:
                            raise BrokenPipeError(
                                "client closed during sendfile")
                        off += sent
                        remaining -= sent
                        file_bytes += sent
                if sf is not None:
                    sf.add("windows")
                    sf.add("file_bytes", file_bytes)
            except (BrokenPipeError, ConnectionResetError,
                    ConnectionAbortedError, OSError):
                # headers already went out: the response cannot be
                # retried on this connection — kill it
                self.close_connection = True
            finally:
                for fd in fds.values():
                    os.close(fd)
                del snap   # held until here: pins the planned files
            return True

        def _route(self) -> Tuple[Optional[str], str, dict]:
            url = urlparse(self.path)
            m = _DOC.match(url.path)
            if not m:
                return None, url.path, parse_qs(url.query)
            return m.group(1), (m.group(2) or ""), parse_qs(url.query)

        def _content_length(self) -> Optional[int]:
            """Content-Length as an int, or None (with a 400 already
            sent) when the header is malformed — int() raising inside
            the handler would abort the connection instead of
            answering (ADVICE r4)."""
            raw = self.headers.get("Content-Length", 0)
            try:
                return int(raw)
            except ValueError:
                self.close_connection = True
                self._send(400, {"error": "malformed Content-Length"})
                return None

        def _body(self, n: int) -> bytes:
            return self.rfile.read(n)

        def _read_trace_headers(self, snap, ae_lag_hdr=None) -> dict:
            """Read-path correlation headers (obs/trace.py): the served
            snapshot's identity plus the session id (adopted from a
            well-formed ``X-Session-Id``, minted otherwise).  A fleet
            store (cluster/gateway.py) additionally stamps the replica
            identity + replica-independent state fingerprint, so a
            replica-local read's staleness is wire-observable
            (``ae_lag_hdr`` carries the staleness gate's own lag
            sample so it is computed once per request)."""
            out = {
                SNAP_FP_HEADER: snap.fingerprint(),
                COMMIT_SEQ_HEADER: str(snap.seq),
                SESSION_HEADER: ensure_session_id(
                    self.headers.get(SESSION_HEADER)),
            }
            if hasattr(store, "extra_read_headers"):
                out.update(store.extra_read_headers(
                    snap, ae_lag_hdr=ae_lag_hdr))
            return out

        @staticmethod
        def _since_headers(hdrs: dict, meta: dict) -> None:
            hdrs[SINCE_FOUND_HEADER] = "1" if meta["found"] else "0"
            hdrs[SINCE_MORE_HEADER] = "1" if meta["more"] else "0"
            if meta["next_since"] is not None:
                hdrs[SINCE_NEXT_HEADER] = str(meta["next_since"])

        def _watch_detach(self, doc, reg, mode, since, limit,
                          deadline, parked_seq,
                          hb_deadline=None) -> bool:
            """The detach seam (serve/reactor.py): this
            caught-up watch connection's socket leaves the handler
            thread and parks on the reactor.  Everything
            request-shaped already happened here — parsing, admission,
            the staleness gate, the resume walk; the reactor only ever
            delivers forward from ``since``.  Steps: drain the
            buffered writer (header/stream bytes must precede reactor
            bytes), mark the socket detached so the server-side
            teardown skips its shutdown/close, flag the registry slot
            as reactor-owned (the ``finally`` below must not release
            it), and hand the socket over.  Returns False when the
            reactor is stopped: the engine is closing, and the caller
            answers with the named close."""
            reactor = store.reactor
            if not reactor.ensure_started():
                return False
            self.wfile.flush()
            sess = ensure_session_id(self.headers.get(SESSION_HEADER))
            keep_alive = not self.close_connection
            self.server.note_detached(self.connection)
            self._watch_detached = True
            # exit the keep-alive handler loop WITHOUT closing: the
            # skip in shutdown_request keeps the fd alive; rfile/wfile
            # close in finish() but the socket object stays open
            self.close_connection = True
            if reactor.park(self.connection, self.client_address,
                            store, doc, reg, mode, since, limit,
                            deadline, parked_seq, sess, keep_alive,
                            hb_deadline=hb_deadline):
                return True
            # stopped between ensure_started and park (shutdown race):
            # the socket is already detached — close it here
            self._watch_detached = False
            try:
                self.connection.close()
            except OSError:
                pass
            return True

        def _watch_poll(self, doc, reg, since, limit, timeout):
            """One long-poll watch round trip (serve/watch.py): answer
            at once when the window already has new ops (*resume*),
            else park the connection on the reactor until the next
            publish (*notify* — latency measured from the pointer
            swap) or the park budget (*timeout* — an empty-batch
            heartbeat bounding how long a dead connection pins its
            slot, stamped with the caught-up window's ``ETag`` so the
            re-poll can validate).  A first poll carrying
            ``If-None-Match`` that does NOT match the window etag also
            delivers — the exactness escape hatch for a client whose
            delete tail predates its watch call.  A delivery more than
            one window behind is a *shed*: the window ships, plus the
            exact resumable mark (``X-Watch-Resume-Since``) — the
            client polls ``/ops`` until caught up, losing nothing.
            The correlation headers resolve against the SAME snapshot
            as the body."""
            deadline = time.monotonic() + timeout
            inm = self.headers.get("If-None-Match")
            snap = doc.snapshot_view()
            body, meta = snap.ops_since_window(since, limit)
            # ONE header builder and freshness predicate for both
            # delivery tiers (serve/watch.py): the reactor's notify
            # bytes and this thread's are identical by construction
            fresh = watch_mod.watch_fresh(meta, since) or (
                inm is not None and not etag_matches(inm, meta["etag"]))
            if fresh or timeout <= 0:
                hdrs = watch_mod.delivery_headers(
                    store, snap, meta, since, ensure_session_id(
                        self.headers.get(SESSION_HEADER)))
            if fresh:
                reg.stats.add("resumes")
                hdrs[WATCH_EVENT_HEADER] = "resume"
                if meta["more"]:
                    reg.stats.add("shed_slow")
                    hdrs[WATCH_EVENT_HEADER] = "shed"
                    hdrs[WATCH_RESUME_HEADER] = str(meta["next_since"])
                self._send_raw(200, body, headers=hdrs)
                return
            if timeout > 0:
                if self._watch_detach(doc, reg, "poll", since, limit,
                                      deadline, snap.seq):
                    return
                self._send(503, {"error": "engine shutting down"},
                           headers={WATCH_EVENT_HEADER: "closed"})
                return
            # a zero budget: the timeout heartbeat at once — an EMPTY
            # wire batch (nothing to re-send), resume mark unchanged,
            # ETag = the caught-up window's validator for the next poll
            hdrs[WATCH_EVENT_HEADER] = "timeout"
            reg.stats.add("heartbeats")
            self._send_raw(200, EMPTY_BATCH_BYTES, headers=hdrs)

        def _watch_sse(self, doc, reg, since, limit, timeout):
            """Streamed watch (``mode=sse``): one response, one
            ``ops`` event per generation (``id:`` = the resume mark),
            comment heartbeats while idle.  The stream closes itself
            on slow-consumer shed (``event: shed`` with the resumable
            mark), on an unknown mark (``event: reset`` — resync via
            snapshot), on the stream budget (``event: bye``), and on
            engine shutdown (``event: closed``) — every close names
            its reason; reconnect-with-mark is always exact.  This
            thread writes the events already due; a caught-up stream
            then parks on the reactor, which writes the rest.  What
            SSE does NOT re-check per event: the bounded-staleness
            gate ran once, at admission — a long-lived stream on a
            partitioned replica keeps serving local generations;
            clients needing a re-armed bound must reconnect."""
            snap = doc.snapshot_view()
            self.close_connection = True    # streams are not reusable
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            for k, v in self._read_trace_headers(snap).items():
                self.send_header(k, v)
            self.end_headers()
            deadline = time.monotonic() + timeout
            hb = max(0.05, reg.heartbeat_s)
            last_seq = None
            while True:
                snap = doc.snapshot_view()
                body, meta = snap.ops_since_window(since, limit)
                # a commit landing between two events re-serves the
                # window even when the terminator did not move (a
                # delete-only tail; duplicates absorb)
                fresh = watch_mod.watch_fresh(meta, since) or (
                    last_seq is not None and snap.seq > last_seq)
                last_seq = snap.seq
                if not fresh:
                    break
                reg.stats.add("resumes")
                ev = bytearray(b"event: ops\n")
                if meta["next_since"] is not None:
                    ev += b"id: %d\n" % meta["next_since"]
                for line in bytes(body).split(b"\n"):
                    ev += b"data: " + line + b"\n"
                ev += b"\n"
                self.wfile.write(ev)
                self.wfile.flush()
                if not meta["found"]:
                    # unknown mark (we restarted with a fresh log): the
                    # client must resync via /snapshot
                    self.wfile.write(b"event: reset\ndata: {}\n\n")
                    return
                if meta["next_since"] is not None:
                    since = meta["next_since"]
                if meta["more"]:
                    reg.stats.add("shed_slow")
                    self.wfile.write(
                        b"event: shed\ndata: "
                        b'{"resume_since": %d}\n\n' % since)
                    return
            if deadline <= time.monotonic():
                self.wfile.write(b"event: bye\ndata: "
                                 b'{"resume_since": %d}\n\n' % since)
                return
            # caught-up stream: the reactor owns it from here
            # (per-generation events, : hb keepalives, named closes)
            if not self._watch_detach(doc, reg, "sse", since, limit,
                                      deadline, snap.seq,
                                      hb_deadline=time.monotonic() + hb):
                self.wfile.write(b"event: closed\ndata: {}\n\n")

        def do_GET(self):
            doc_id, sub, query = self._route()
            if doc_id is None:
                if sub == "/metrics":
                    self._send(200, {d: store.get(d).metrics()
                                     for d in store.ids()})
                elif sub == "/metrics/scheduler" and \
                        hasattr(store, "scheduler_metrics"):
                    self._send(200, store.scheduler_metrics())
                elif sub == "/metrics/prom" and \
                        hasattr(store, "render_prom"):
                    # the unified Prometheus-style scrape: doc counters,
                    # scheduler histograms with bucket bounds, the span
                    # registry, flight gauges (obs/prom.py)
                    self._send_raw(200, store.render_prom().encode(),
                                   ctype=prom_mod.CONTENT_TYPE)
                elif sub == "/debug/flight" and \
                        hasattr(store, "debug_flight"):
                    # the flight recorder's ring + counters, enriched
                    # for post-mortem without waiting for a dump file
                    self._send(200, store.debug_flight())
                elif sub.startswith("/debug/trace/") and \
                        hasattr(store, "debug_trace"):
                    # fleet trace assembly (docs/OBSERVABILITY.md
                    # §Fleet tracing): this node's spans for the id
                    # plus — unless ?federate=0, which is what the
                    # federated fetch itself sends so assembly is one
                    # bounded hop, never recursive — every peer's
                    tid = sub[len("/debug/trace/"):]
                    fed = query.get("federate", ["1"])[0] != "0"
                    self._send(200, store.debug_trace(
                        tid, federate=fed))
                elif sub.startswith("/debug/visibility/") and \
                        hasattr(store, "debug_visibility"):
                    # the visibility ledger's per-doc tail: when each
                    # recent commit became durable / published /
                    # watch-delivered here, plus frontier applies
                    # pulled from peers (bounds, not truths)
                    self._send(200, store.debug_visibility(
                        sub[len("/debug/visibility/"):]))
                elif sub == "/docs":
                    self._send(200, {"docs": store.ids()})
                elif sub == "/cluster" and \
                        hasattr(store, "cluster_view"):
                    # fleet introspection: membership, lease, ring
                    # spread, anti-entropy state (docs/CLUSTER.md)
                    self._send(200, store.cluster_view())
                else:
                    self._send(404, {"error": "not found"})
                return
            doc = store.get(doc_id, create=False)
            if doc is None:
                # rejoining-node catch-up (cluster/gateway.py): when a
                # fleet peer HAS this document, this node is merely
                # behind (restart / fresh ring ownership) — answer an
                # honest 503 + Retry-After with a catch-up hint and
                # trigger a priority anti-entropy pull, instead of the
                # long 404 window the background sync left before
                cs = store.catchup_status(doc_id) \
                    if hasattr(store, "catchup_status") else None
                if cs is not None:
                    self._send(
                        503, {"error": f"document {doc_id} is being "
                                       "caught up from the fleet",
                              "retry_after_s": cs["retry_after_s"]},
                        headers={"Retry-After": str(cs["retry_after_s"]),
                                 CATCHUP_REMAINING_HEADER:
                                     str(cs["remaining"])})
                    return
                self._send(404, {"error": f"no document {doc_id}"})
                return
            ae_lag_hdr = None
            if sub in ("", "/snapshot", "/watch") and \
                    hasattr(store, "check_staleness"):
                # bounded-staleness read contract (docs/CLUSTER.md
                # §Partitions & staleness): a read bounded by
                # X-Max-Staleness (or the server's
                # GRAFT_MAX_STALENESS_S default) on a replica whose
                # anti-entropy lag exceeds the bound gets an honest
                # 503 + Retry-After instead of silently stale data —
                # a partitioned replica degrades, it does not lie.
                # The gate's lag sample also feeds the served read's
                # X-Ae-Lag-Seconds stamp (one sample per request —
                # gate and stamp can never disagree)
                stale, ae_lag_hdr = store.check_staleness(
                    self.headers.get(MAX_STALENESS_HEADER))
                if stale is not None:
                    # lag_s is None when unbounded (a replica that has
                    # never fully synced) — Infinity is not valid JSON
                    lag_txt = "unbounded" if stale["lag_s"] is None \
                        else f"{stale['lag_s']}s"
                    self._send(
                        503,
                        {"error": f"replica staleness {lag_txt} "
                                  f"exceeds the {stale['bound_s']}s "
                                  "bound",
                         "ae_lag_s": stale["lag_s"],
                         "retry_after_s": stale["retry_after_s"]},
                        headers={
                            "Retry-After": str(stale["retry_after_s"]),
                            AE_LAG_HEADER: ae_lag_hdr})
                    return
            if sub == "":
                if hasattr(doc, "read_view"):
                    # body and headers come from the SAME snapshot: a
                    # checker correlating the fingerprint header to the
                    # values body must never straddle a publish.  The
                    # body is the generation's CACHED encoding
                    # (serve/snapshot.py) and the read is conditional:
                    # If-None-Match against the state-fingerprint ETag
                    # answers 304 with the full header set but no body
                    # — polling readers of an idle doc stop paying
                    # O(doc) egress.  The staleness gate above already
                    # overrode this path with its 503 when the bound
                    # was exceeded: a 304 never vouches for freshness
                    # beyond what the lag stamp admits.
                    snap = doc.read_view()
                    hdrs = self._read_trace_headers(
                        snap, ae_lag_hdr=ae_lag_hdr)
                    hdrs["ETag"] = snap.etag()
                    if etag_matches(self.headers.get("If-None-Match"),
                                    snap.etag()):
                        snap.cache_stats.served_304()
                        self._send_raw(304, b"", headers=hdrs)
                    else:
                        self._send_raw(200, snap.values_body(),
                                       headers=hdrs)
                else:       # legacy DocumentStore: no snapshot identity
                    self._send(200, {"values": doc.snapshot()})
            elif sub == "/ops":
                try:
                    since = int(query.get("since", ["0"])[0])
                    limit = int(query.get("limit", ["0"])[0])
                except ValueError:
                    self._send(400, {"error": "since and limit must "
                                              "be integers"})
                    return
                # a pull that names its fleet node (X-Ae-Peer) feeds
                # the causal-stability watermark: the peer provably
                # consumed our log through `since`, which is what
                # gates the cascade op-log's checkpoint advancement
                # and segment GC (cluster/gateway.py, docs/OPLOG.md)
                peer = self.headers.get(AE_PEER_HEADER)
                if peer and hasattr(store, "note_peer_mark"):
                    store.note_peer_mark(doc_id, peer, since)
                # pre-encoded fast path: the bootstrap contract serves
                # the full log, so avoid a json.loads/dumps round trip.
                # With ?limit= (anti-entropy pulls) the window is
                # bounded + resumable and its state rides the
                # X-Since-* headers — the body stays a plain wire
                # batch either way (engine.packed_since_window)
                try:
                    # zero-copy fast path: a catch-up
                    # window landing entirely on cold segments with
                    # ready wire sidecars ships as os.sendfile ranges
                    # — byte-, header-, and ETag-identical to the
                    # buffered branch below, which remains the answer
                    # for hot/mixed windows
                    if limit > 0 and hasattr(doc, "ops_window_plan"):
                        plan = doc.ops_window_plan(since, limit)
                        if plan is not None \
                                and self._serve_ops_plan(doc, plan):
                            return
                    if limit > 0 and hasattr(doc, "ops_since_window"):
                        body, meta = doc.ops_since_window(since, limit)
                        hdrs = {
                            SINCE_FOUND_HEADER:
                                "1" if meta["found"] else "0",
                            SINCE_MORE_HEADER:
                                "1" if meta["more"] else "0",
                            **({SINCE_NEXT_HEADER:
                                str(meta["next_since"])}
                               if meta["next_since"] is not None
                               else {}),
                        }
                        # fleet tracing: the window rides
                        # out with our send timestamp + the doc's
                        # recent commit trace ids so the PULLING node
                        # can stamp ae_apply spans and a visibility
                        # BOUND; absent under GRAFT_FLEETTRACE=0
                        if hasattr(store, "trace_frontier_header"):
                            tf = store.trace_frontier_header(doc_id)
                            if tf:
                                hdrs[TRACE_FRONTIER_HEADER] = tf
                        # conditional window pull:
                        # the window's content fingerprint is its ETag,
                        # so a steady-state anti-entropy re-pull of an
                        # unchanged window (every peer re-asking the
                        # same (since, limit) of an idle doc every
                        # round) becomes a bodyless 304 ON THE WIRE —
                        # the X-Since-* resume state still rides the
                        # headers, so the puller's mark advances
                        # exactly as a 200 would have advanced it
                        wetag = meta.get("etag")
                        if wetag:
                            hdrs["ETag"] = wetag
                            if etag_matches(
                                    self.headers.get("If-None-Match"),
                                    wetag):
                                if hasattr(doc, "readcache"):
                                    doc.readcache.served_304()
                                self._send_raw(304, b"", headers=hdrs)
                                return
                        self._send_raw(200, body, headers=hdrs)
                    else:
                        self._send_raw(200,
                                       doc.dumps_since_bytes(since))
                except CheckpointError as e:
                    # a window that touches a quarantined (bit-rotted)
                    # tier file: typed refusal + Retry-After — the
                    # scrub repair path is healing the range; corrupt
                    # bytes are NEVER served (docs/DURABILITY.md
                    # §Scrub & repair)
                    self._send(503, {"error": str(e),
                                     "retry_after_s": 5},
                               headers={"Retry-After": "5"})
            elif sub == "/watch":
                # delta-push fan-out (serve/watch.py; docs/SERVING.md
                # §Watch & fan-out): park on the publish pointer, wake
                # on the next generation, deliver the PR-15 cached
                # window — one encode per generation shared by every
                # watcher.  The staleness gate above already ran: a
                # bounded-staleness 503 outranks parking.
                if not hasattr(doc, "watch"):
                    self._send(404, {"error": "watch requires the "
                                              "serving engine"})
                    return
                reg = doc.watch
                try:
                    since = int(query.get("since", ["0"])[0])
                    limit = int(query.get("limit", ["0"])[0]) \
                        or DEFAULT_WATCH_LIMIT
                    timeout = float(
                        query.get("timeout", [""])[0] or reg.park_s)
                except ValueError:
                    self._send(400, {"error": "since, limit, timeout "
                                              "must be numeric"})
                    return
                if limit < 0 or timeout < 0:
                    self._send(400, {"error": "limit and timeout "
                                              "must be >= 0"})
                    return
                mode = query.get("mode", ["poll"])[0]
                # long-poll park is capped by the registry budget; an
                # SSE stream legitimately spans many generations so it
                # gets 10× (heartbeats bound dead-connection detection
                # either way)
                timeout = min(timeout, reg.park_s *
                              (10.0 if mode == "sse" else 1.0))
                try:
                    # bounded admission: past GRAFT_WATCH_MAX the
                    # watch is shed at the door, same semantic as the
                    # write queue's 429
                    reg.register()
                except WatchFull as e:
                    self._send(429, {"error": str(e),
                                     "retry_after_s": e.retry_after_s},
                               headers={"Retry-After":
                                        str(e.retry_after_s)})
                    return
                except WatchClosed as e:
                    self._send(503, {"error": str(e)})
                    return
                self._watch_detached = False
                try:
                    if mode == "sse":
                        self._watch_sse(doc, reg, since, limit,
                                        timeout)
                    else:
                        self._watch_poll(doc, reg, since, limit,
                                         timeout)
                except CheckpointError as e:
                    # quarantined tier range mid-watch: same typed
                    # refusal as /ops — never corrupt bytes
                    self._send(503, {"error": str(e),
                                     "retry_after_s": 5},
                               headers={"Retry-After": "5"})
                except (BrokenPipeError, ConnectionResetError,
                        ConnectionAbortedError, OSError):
                    # the watcher hung up while parked or mid-write:
                    # count the reap, release the slot (finally), and
                    # let the connection die quietly
                    reg.stats.add("reaped")
                    self.close_connection = True
                finally:
                    if not self._watch_detached:
                        reg.unregister()
                    # a detached slot is the reactor's to release:
                    # its delivery/heartbeat/reap/close unregisters
                    # with the same lifetime as the handler's
            elif sub == "/snapshot":
                try:
                    if hasattr(doc, "read_view"):
                        snap = doc.read_view()
                        hdrs = self._read_trace_headers(
                            snap, ae_lag_hdr=ae_lag_hdr)
                        hdrs["ETag"] = snap.etag()
                        if etag_matches(
                                self.headers.get("If-None-Match"),
                                snap.etag()):
                            # the 304 fires BEFORE checkpoint_bytes:
                            # an unchanged bootstrap poll skips the
                            # whole O(doc) npz assembly, not just the
                            # egress
                            snap.cache_stats.served_304()
                            self._send_raw(
                                304, b"",
                                ctype="application/octet-stream",
                                headers=hdrs)
                            return
                        self._send_raw(
                            200, snap.checkpoint_bytes(),
                            ctype="application/octet-stream",
                            headers=hdrs)
                    else:
                        self._send_raw(200, doc.snapshot_packed(),
                                       ctype="application/octet-stream")
                except CheckpointError as e:
                    # same quarantine rule as /ops: a checkpoint
                    # reassembly that needs a quarantined file refuses
                    # honestly instead of serving corrupt bytes
                    self._send(503, {"error": str(e),
                                     "retry_after_s": 5},
                               headers={"Retry-After": "5"})
            elif sub == "/clock":
                if hasattr(doc, "snapshot_view"):
                    # the clock wire body is cached per generation too.
                    # Deliberately snapshot_view, NOT read_view: the
                    # one-shot GRAFT_ORACLE_FAULT stale/regress faults
                    # must fire on a VALUE/snapshot read (where the
                    # oracle can catch them), never be consumed by a
                    # clock poll — doc.clock() always read the
                    # published snapshot directly
                    self._send_raw(200,
                                   doc.snapshot_view().clock_body())
                else:
                    self._send(200, {"replicas": doc.clock()})
            elif sub == "/metrics":
                self._send(200, doc.metrics())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            # reject oversized bodies before reading them (the connection
            # closes: unread body bytes would otherwise be parsed as the
            # next request line on keep-alive)
            n = self._content_length()
            if n is None:
                return
            if n > max_body:
                self.close_connection = True
                self._send(413, {"error": f"body exceeds {max_body} "
                                          "bytes; chunk the batch"})
                return
            # always drain the request body first (keep-alive connections
            # would otherwise read leftover body bytes as the next request
            # line), and validate the route BEFORE store.get(create=True)
            # so invalid requests never materialize documents
            body = self._body(n)
            doc_id, sub, _ = self._route()
            # merge-tier wire surface (docs/MERGETIER.md): a merge
            # worker — any store exposing ``handle_merge`` — answers
            # ``POST /merge`` with the packed-npz codec's bytes; the
            # handler shape mirrors the fleet forward path so both
            # transports serve identical responses
            if doc_id is None and sub == "/merge" \
                    and hasattr(store, "handle_merge"):
                status, out_body, out_headers = store.handle_merge(body)
                ctype = out_headers.pop("Content-Type",
                                        "application/octet-stream")
                self._send_raw(status, out_body, ctype=ctype,
                               headers=out_headers)
                return
            if doc_id is None or sub not in ("/replicas", "/ops"):
                self._send(404, {"error": "not found"})
                return
            if sub == "/replicas":
                # a fleet store allocates from the shared KV counter so
                # ids stay unique across servers AND across primary
                # failover; the single-server path keeps the local
                # per-document counter
                if hasattr(store, "assign_replica"):
                    store.get(doc_id)      # materialize the local doc
                    rid = store.assign_replica(doc_id)
                else:
                    rid = store.get(doc_id).assign_replica()
                self._send(200, {"replica": rid})
                return
            # fleet write routing (cluster/gateway.py): a non-primary
            # node relays the request to the document's primary and
            # answers with the PRIMARY's response verbatim (status,
            # trace echo, Retry-After backpressure included); a request
            # already forwarded once always applies locally — one hop,
            # no loops
            if hasattr(store, "write_route") \
                    and self.headers.get(FORWARDED_HEADER) is None:
                try:
                    fwd = store.forward_write(
                        doc_id, body,
                        {TRACE_HEADER: self.headers.get(TRACE_HEADER),
                         SESSION_HEADER:
                             self.headers.get(SESSION_HEADER)})
                except ForwardError as e:
                    self._send(503, {"error": str(e)},
                               headers={"Retry-After":
                                        str(e.retry_after_s)})
                    return
                if fwd is not None:
                    status, out_body, out_headers = fwd
                    ctype = out_headers.pop("Content-Type",
                                            "application/json")
                    self._send_raw(status, out_body, ctype=ctype,
                                   headers=out_headers)
                    return
            elif self.headers.get(FORWARDED_HEADER) is not None \
                    and hasattr(store, "note_forwarded_in"):
                store.note_forwarded_in()
            # trace admission point (obs/trace.py): mint — or adopt a
            # well-formed client-supplied X-Trace-Id — BEFORE parsing,
            # so even a malformed or shed request is attributable; the
            # id rides the write ticket into the commit's flight record
            # and is echoed in the response (body + header) so a client
            # report joins against the server-side record
            trace_id = ensure_trace_id(self.headers.get(TRACE_HEADER))
            # fleet tracing: a forwarded write carries the
            # sender's X-Span-Ctx — splice its hop into OUR span ring
            # under the shared trace id before the commit's own spans
            span_ctx = self.headers.get(SPAN_CTX_HEADER)
            if span_ctx and hasattr(store, "note_span_ctx"):
                store.note_span_ctx(trace_id, span_ctx)
            trace_hdr = {TRACE_HEADER: trace_id}
            # echo a client-supplied session id on writes too, so one
            # session's whole request stream correlates on both paths
            sess = self.headers.get(SESSION_HEADER)
            if is_valid_id(sess):
                trace_hdr[SESSION_HEADER] = sess
            try:
                accepted, applied = store.get(doc_id).apply_body(
                    body, trace_id=trace_id)
            except QueueFull as e:
                # admission control: the merge queue is at capacity —
                # shed the write at the door with the server's own
                # drain-time estimate (serve/queue.py)
                self._send(429, {"error": str(e),
                                 "retry_after_s": e.retry_after_s,
                                 "trace_id": trace_id},
                           headers={"Retry-After": str(e.retry_after_s),
                                    **trace_hdr})
                return
            except SchedulerStopped as e:
                self._send(503, {"error": str(e), "trace_id": trace_id},
                           headers=trace_hdr)
                return
            except SchedulerError as e:
                # server-side merge failure: MUST answer 500, never a
                # client-error class — this request was well-formed and
                # retrying it later is legitimate
                self._send(500, {"error": str(e), "trace_id": trace_id},
                           headers=trace_hdr)
                return
            except (DecodeError, json.JSONDecodeError, ValueError) as e:
                # ValueError: the native parser's rejections (same
                # malformed-input class as DecodeError)
                self._send(400, {"error": str(e), "trace_id": trace_id},
                           headers=trace_hdr)
                return
            from ..core import operation as op_mod
            n_applied = op_mod.count(applied)
            payload = {"accepted": accepted, "applied_count": n_applied,
                       "trace_id": trace_id}
            if hasattr(store, "served_by"):
                # fleet attribution: the node that committed this
                # write (the oracle keys read-your-writes on it)
                payload["served_by"] = store.served_by()
            # echo the applied ops only for interactive-scale deltas —
            # for a bootstrap-size push, re-encoding the whole batch
            # into the response costs multiples of the merge itself
            # (scripts/bench_service_e2e.py) and the client already has
            # the ops it sent
            if n_applied <= ECHO_LIMIT:
                payload["applied"] = json.loads(store.encode_ops(applied))
            self._send(200 if accepted else 409, payload,
                       headers=trace_hdr)

    return Handler


class ServingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that shuts an OWNED serving engine down with
    the server — the scheduler thread stops and any in-flight write
    tickets resolve (503) before ``server_close`` returns.

    Connections are HTTP/1.1 keep-alive (every client path pools them
    through :class:`~crdt_graph_tpu_torch.cluster.pool.ConnectionPool`), so
    ``server_close`` also force-closes every ESTABLISHED connection:
    stopping the accept loop alone would leave handler threads serving
    pooled keep-alive connections of a "crashed" fleet member — a
    zombie the per-request-connection era never had (the chaos tests'
    kill semantics depend on a crash actually severing the wire)."""

    owned_engine: Optional[ServingEngine] = None

    # reactor-scale ramp: thousands of watcher connects can
    # arrive in one burst; socketserver's default backlog of 5 would
    # RST the tail of the herd at the kernel accept queue
    request_queue_size = 128

    def __init__(self, *args, **kw):
        self._conn_lock = threading.Lock()
        self._live_conns: set = set()
        self._detached: set = set()
        super().__init__(*args, **kw)

    def process_request(self, request, client_address):
        with self._conn_lock:
            self._live_conns.add(request)
        super().process_request(request, client_address)

    def note_detached(self, request) -> None:
        """The detach seam (serve/reactor.py): a watch handler hands
        this connection's socket to the reactor and exits.  From here
        the reactor owns the socket's lifetime — the handler-thread
        teardown (``shutdown_request``) must skip the shutdown/close
        it would otherwise do, and ``server_close`` must not sever it
        (the engine's ``close()`` drains the reactor with named
        closes instead)."""
        with self._conn_lock:
            self._live_conns.discard(request)
            self._detached.add(request)

    def shutdown_request(self, request):
        with self._conn_lock:
            if request in self._detached:
                self._detached.discard(request)
                return          # the reactor owns this socket now
            self._live_conns.discard(request)
        super().shutdown_request(request)

    def server_close(self):
        super().server_close()
        with self._conn_lock:
            live = list(self._live_conns)
            self._live_conns.clear()
        for sock in live:
            # a hard RST-like severance: handler threads blocked on
            # the next keep-alive request line wake with EOF and exit
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        if self.owned_engine is not None:
            self.owned_engine.close()

    def handle_error(self, request, client_address):
        """A client that hung up mid-response is routine operation —
        long-poll writers time out, fleet peers crash (chaos tests
        kill them on purpose) — not a stack trace on stderr.  Anything
        that is NOT a connection death still gets the default dump."""
        import sys as _sys
        exc = _sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError,
                            ConnectionAbortedError, TimeoutError)):
            return
        super().handle_error(request, client_address)


def make_server(port: int = 0, store=None,
                max_body: int = DEFAULT_MAX_BODY,
                device=None) -> ThreadingHTTPServer:
    """Build the wire server.  ``store`` defaults to a fresh
    :class:`~crdt_graph_tpu_torch.serve.ServingEngine` on ``device``
    (the card unless the caller names another; snapshot reads + merge
    scheduler; closed with the server); pass a ``DocumentStore`` for the
    legacy inline-merge path or a pre-configured engine the caller
    owns."""
    owned = store is None
    store = store if store is not None else ServingEngine(device=device)
    server = ServingHTTPServer(("127.0.0.1", port),
                               make_handler(store, max_body=max_body))
    server.store = store
    if owned:
        server.owned_engine = store
    # reactor egress (serve/reactor.py): the reactor re-injects a
    # keep-alive connection's NEXT request through the server's
    # process_request, so it needs the server reference
    reactor = getattr(store, "reactor", None)
    if reactor is not None:
        reactor.server = server
    return server


def serve(port: int = 8900) -> None:
    """Serve on ``port`` (0 picks a free one, printed) until SIGTERM or
    SIGINT, then close the engine: queued commits resolve, and its
    host-shared segment claims (``GRAFT_SHMCACHE``) are released."""
    import signal

    def _term(signum, frame):
        raise KeyboardInterrupt

    server = make_server(port)
    signal.signal(signal.SIGTERM, _term)
    print(f"crdt_graph_tpu_torch service on "
          f"127.0.0.1:{server.server_port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
