"""Persistent pooled HTTP connections for every inter-node client path
(docs/CLUSTER.md §Pooled connections).

Every fleet client used to open a fresh TCP connection per request —
anti-entropy pulls, write forwards, repair fetches, and the merge-tier
client — which at loopback test rates meant thousands of
TIME_WAIT 4-tuples and the occasional kernel RST on a reused tuple
(which a client can only paper over with a retry).  The serving
side has been HTTP/1.1 keep-alive all along; this pool is the client
half: a small per-``(src, dst, host, port)`` stack of idle
connections, leased and released around each request (or each
anti-entropy round).

Chaos compatibility is the design constraint: connections are created
through the **``netchaos.connect`` factory** (via the ``connect``
callable the owner passes in), so a pooled connection is a
``ChaosHTTPConnection`` whenever a fault plan is armed and every
request still draws from the per-link seeded decision stream — drop /
delay / cut / dup / partition faults bite pooled traffic exactly as
they bit per-request connections.  A fault (or any transport error)
POISONS exactly the pooled connection it hit: ``release(conn,
ok=False)`` closes it and counts it, and the next lease opens fresh.

Stale reuse is the one new failure mode pooling introduces (the peer
closed an idle connection; the client finds out at the next request).
:meth:`ConnectionPool.request` absorbs it: a request that dies with a
connection-reset class on a REUSED connection retries once on a fresh
one (counted as ``stale_retries``, not an error).  A fresh
connection's failure — including an injected ``ConnectionRefused``
drop — always propagates: retrying chaos away would defeat it.

Counters (``crdt_connpool_*`` prom families, and
``/cluster``): ``opens``, ``reuses``, ``evictions`` (idle
overflow + max-age), ``poisoned``, ``stale_retries``.
"""
from __future__ import annotations

import threading
import time
from http.client import HTTPConnection, RemoteDisconnected
from typing import Any, Callable, Dict, Optional, Tuple

# error classes that mean "the reused connection went stale under us"
# — retried once on a fresh connection by request().  Deliberately
# excludes ConnectionRefusedError: a refusal is a dead peer or an
# injected netchaos drop, and both must reach the caller's
# peer-failure handling.
STALE_ERRORS = (RemoteDisconnected, ConnectionResetError,
                BrokenPipeError, ConnectionAbortedError)


def _plain_connect(src: str, dst: str, host: str, port: int,
                   timeout: float) -> HTTPConnection:
    return HTTPConnection(host, int(port), timeout=timeout)


class ConnectionPool:
    """A bounded keep-alive connection pool keyed by
    ``(src, dst, host, port)`` — the same logical-link identity the
    netchaos decision streams key on, so pooling never blurs which
    link a fault fired on."""

    def __init__(self, connect: Optional[Callable] = None,
                 max_idle_per_link: int = 4,
                 max_age_s: float = 15.0):
        # the factory is the chaos seam: a ClusterNode passes
        # ``lambda *a: netchaos.connect(node.netchaos, *a)`` so pooled
        # links ride the armed fault plan; harness verification pools
        # keep the plain default
        self._connect = connect or _plain_connect
        self.max_idle_per_link = max(1, int(max_idle_per_link))
        self.max_age_s = float(max_age_s)
        self._mu = threading.Lock()
        self._idle: Dict[Tuple, list] = {}
        self._closed = False
        self.opens = 0
        self.reuses = 0
        self.evictions = 0
        self.poisoned = 0
        self.stale_retries = 0

    # -- lease / release ---------------------------------------------------

    def lease(self, src: str, dst: str, host: str, port: int,
              timeout: float, fresh: bool = False) -> HTTPConnection:
        """One connection for the link, reused when an idle one is
        fresh enough (``max_age_s`` keeps us ahead of server-side idle
        reaping), opened through the factory otherwise.  The returned
        connection carries ``_pool_reused`` so callers can tell a
        stale-reuse failure from a genuine one.  ``fresh=True`` skips
        the idle list entirely — the stale-retry path must get a
        GUARANTEED-fresh connection, not the next idle candidate (a
        peer restart can stale several pooled connections at once)."""
        key = (src, dst, host, int(port))
        now = time.monotonic()
        while not fresh:
            with self._mu:
                entries = self._idle.get(key)
                entry = entries.pop() if entries else None
                if entries is not None and not entries:
                    self._idle.pop(key, None)
            if entry is None:
                break
            conn, t_idle = entry
            if now - t_idle > self.max_age_s:
                with self._mu:
                    self.evictions += 1
                self._close_quietly(conn)
                continue
            with self._mu:
                self.reuses += 1
            conn.timeout = timeout
            if getattr(conn, "sock", None) is not None:
                try:
                    conn.sock.settimeout(timeout)
                except OSError:
                    pass
            conn._pool_reused = True
            return conn
        with self._mu:
            self.opens += 1
        conn = self._connect(src, dst, host, int(port), timeout)
        conn._pool_key = key
        conn._pool_reused = False
        return conn

    def release(self, conn: HTTPConnection, ok: bool = True) -> None:
        """Return a connection after its response was FULLY read.
        ``ok=False`` poisons it (any transport/chaos failure — the
        caller cannot know what bytes are stranded in flight); idle
        overflow evicts the oldest."""
        key = getattr(conn, "_pool_key", None)
        if key is None:
            self._close_quietly(conn)
            return
        if not ok:
            with self._mu:
                self.poisoned += 1
            self._close_quietly(conn)
            return
        with self._mu:
            if self._closed:
                evict = [(conn, 0.0)]
            else:
                entries = self._idle.setdefault(key, [])
                entries.append((conn, time.monotonic()))
                evict = []
                while len(entries) > self.max_idle_per_link:
                    evict.append(entries.pop(0))
                    self.evictions += 1
        for c, _ in evict:
            self._close_quietly(c)

    # -- one-shot pooled request -------------------------------------------

    def request(self, src: str, dst: str, host: str, port: int,
                method: str, path: str, body=None, headers=None,
                timeout: float = 30.0):
        """lease → request → getresponse → full read → release, with
        the single stale-reuse retry (module docstring).  Returns
        ``(resp, raw)`` — the response object is fully consumed, so
        ``getheader`` works and the connection is already back in the
        pool."""
        for attempt in (0, 1):
            conn = self.lease(src, dst, host, port, timeout,
                              fresh=bool(attempt))
            reused = getattr(conn, "_pool_reused", False)
            try:
                conn.request(method, path, body=body,
                             headers=headers or {})
                resp = conn.getresponse()
                raw = resp.read()
            except STALE_ERRORS:
                self.release(conn, ok=False)
                if reused and attempt == 0:
                    with self._mu:
                        self.stale_retries += 1
                    continue
                raise
            except BaseException:
                self.release(conn, ok=False)
                raise
            if getattr(resp, "will_close", False):
                # the server told us it is closing (413/malformed-
                # length paths): not a fault, just not reusable
                with self._mu:
                    self.evictions += 1
                self._close_quietly(conn)
            else:
                self.release(conn, ok=True)
            return resp, raw
        raise RuntimeError("unreachable")

    # -- lifecycle / exposition --------------------------------------------

    @staticmethod
    def _close_quietly(conn) -> None:
        try:
            conn.close()
        except OSError:
            pass

    def close(self) -> None:
        with self._mu:
            self._closed = True
            entries = [c for lst in self._idle.values() for c, _ in lst]
            self._idle.clear()
        for c in entries:
            self._close_quietly(c)

    def stats(self) -> Dict[str, Any]:
        with self._mu:
            idle = sum(len(v) for v in self._idle.values())
            return {"opens": self.opens, "reuses": self.reuses,
                    "evictions": self.evictions,
                    "poisoned": self.poisoned,
                    "stale_retries": self.stale_retries,
                    "idle": idle, "links": len(self._idle)}
