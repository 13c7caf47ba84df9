"""Delta-push fan-out headline: what parking readers on the publish
pointer buys over polling, same host, interleaved A/B — the port's
counterpart of ``scripts/bench_fanout_headline.py``, merging on the
card unless ``device`` names another.

Two sections:

**1. The 1,000-watcher fan-out.**  One document, ≥ 1,000 concurrent
watchers parked at the same mark over raw keep-alive sockets (cheap
parked connections — no client thread per watcher), then ONE commit.
Every watcher must receive the SAME generation as byte-identical
bodies served from ONE cached encode — pinned by the readcache
counters (misses +1, hits +(N-1): the first woken watcher is elected
leader and encodes, the rest hit the in-flight latch).  The notify
histogram (commit-publish → delivery write) reports the fan-out p50/
p99/max across the whole population.

**2. Watch vs poll, interleaved A/B.**  The same client population
(one pooled connection each, one request in flight) consumes the same
write stream two ways, alternating legs per round:

- ``poll`` — ``GET /ops?since=`` on a fixed cadence
  (``POLL_INTERVAL_S``, a realistic UI freshness budget): the client
  pays the budget even though the data is already there;
- ``watch`` — ``GET /watch?since=`` long-poll: caught-up requests
  park and deliver at COMMIT cadence, behind requests deliver
  immediately.

``reads_delivered/s`` counts FRESH windows received (the mark moved).
Both legs run the same oracle: marks never regress, and after a
drain-to-quiescence every client's reassembled replica must equal the
served document exactly — resume loses nothing, duplicates nothing.
Gate: best watch leg ≥ 2× best poll leg, zero violations both legs.

Writes ``build/headline/BENCH_FANOUT.json`` (or ``out_path``).  Run:
``python -m crdt_graph_tpu_torch.scripts.bench_fanout_headline
[out_path] [--device cpu]``.
"""
from __future__ import annotations

import json
import socket
import sys
import threading
import time

from . import _headline
from .. import engine as engine_mod
from ..cluster.pool import ConnectionPool
from ..codec import json_codec
from ..core.operation import Add, Batch
from ..serve import ServingEngine
from ..serve.watch import merge_notify_hists
from ..service import make_server

WATCHERS = 1000
AB_CLIENTS = 16
AB_WALL_S = 4.0
POLL_INTERVAL_S = 0.2
WRITE_GAP_S = 0.02
LEGS = ("watch", "poll")


def _chain(rid: int, n: int, start: int = 1, prev: int = 0) -> str:
    ops = []
    for c in range(start, start + n):
        ts = rid * 2**32 + c
        ops.append(Add(ts, (prev,), f"r{rid}:{c}"))
        prev = ts
    return json_codec.dumps(Batch(tuple(ops)))


def _read_http(sock: socket.socket):
    """One keep-alive HTTP response off a raw socket:
    ``(status, headers, body)``."""
    sock.settimeout(120)
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("eof before headers")
        buf += chunk
    head, _, rest = buf.partition(b"\r\n\r\n")
    lines = head.split(b"\r\n")
    status = int(lines[0].split()[1])
    hdrs = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(b": ")
        hdrs[k.decode().lower()] = v.decode()
    clen = int(hdrs.get("content-length", "0"))
    while len(rest) < clen:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("eof before body")
        rest += chunk
    return status, hdrs, rest[:clen]


def _fanout_population(n: int = None, dev=None) -> dict:
    """Park ``n`` watchers (default ``WATCHERS``) at one mark, commit
    ONCE, and account for every delivery: byte-identity, the one-encode
    pin, notify p99."""
    n = WATCHERS if n is None else n
    engine = ServingEngine(watch_max=n + 64, device=dev)
    srv = make_server(port=0, store=engine)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    pool = ConnectionPool()
    socks = []
    try:
        def req(method, path, body=None):
            resp, raw = pool.request(
                "bench-main", "server", "127.0.0.1", srv.server_port,
                method, path, body=body)
            return resp.status, raw, {k: v
                                      for k, v in resp.getheaders()}

        st, raw, _ = req("POST", "/docs/fan/ops", body=_chain(1, 8))
        assert st == 200 and json.loads(raw)["accepted"], raw
        st, _, hdr = req("GET", "/docs/fan/ops?since=0&limit=100000")
        mark = int(hdr["X-Since-Next"])
        d = engine.get("fan")
        d.watch.park_s = 600.0       # the population parks for a while

        t_park0 = time.monotonic()
        line = (f"GET /docs/fan/watch?since={mark}&limit=100000"
                f"&timeout=600 HTTP/1.1\r\nHost: bench\r\n\r\n"
                ).encode()
        mu = threading.Lock()

        def connect_batch(count):
            for _ in range(count):
                s = socket.create_connection(
                    ("127.0.0.1", srv.server_port), timeout=120)
                s.sendall(line)
                with mu:
                    socks.append(s)

        lanes = 8
        per = [n // lanes + (1 if i < n % lanes else 0)
               for i in range(lanes)]
        conns = [threading.Thread(target=connect_batch, args=(c,),
                                  daemon=True) for c in per]
        for t in conns:
            t.start()
        for t in conns:
            t.join(300)
        assert len(socks) == n
        deadline = time.monotonic() + 300
        while d.watch.counts()["parked"] < n:
            assert time.monotonic() < deadline, d.watch.counts()
            time.sleep(0.02)
        park_wall = time.monotonic() - t_park0

        rc0 = d.readcache.snapshot()
        t_commit0 = time.monotonic()
        st, raw, _ = req("POST", "/docs/fan/ops",
                         body=_chain(2, 4))
        assert st == 200 and json.loads(raw)["accepted"], raw
        bodies, events = set(), {}
        for s in socks:
            status, hdrs, body = _read_http(s)
            assert status == 200, (status, hdrs)
            bodies.add(body)
            ev = hdrs.get("x-watch-event", "?")
            events[ev] = events.get(ev, 0) + 1
        deliver_wall = time.monotonic() - t_commit0
        rc1 = d.readcache.snapshot()

        misses = rc1["misses"] - rc0["misses"]
        hits = rc1["hits"] - rc0["hits"]
        nm = merge_notify_hists([d.watch.stats.notify_ms.export()])
        ws = d.watch.stats.snapshot()
        out = {
            "watchers": n,
            "park_wall_s": round(park_wall, 3),
            "deliver_wall_s": round(deliver_wall, 3),
            "events": events,
            "unique_bodies": len(bodies),
            "readcache_misses_delta": misses,
            "readcache_hits_delta": hits,
            "one_encode": misses == 1 and hits == n - 1,
            "notify_ms": nm,
            "server_notifies": ws["notifies"],
            "registered_after": d.watch.counts()["registered"],
        }
        assert out["unique_bodies"] == 1, events
        assert events.get("notify") == n, events
        assert out["one_encode"], (misses, hits)
        assert nm["count"] == n
        assert out["registered_after"] == 0
        return out
    finally:
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        pool.close()
        srv.shutdown()
        srv.server_close()
        engine.close()


class _ABClient(threading.Thread):
    """One consumer: a pooled connection, one request in flight, a
    private replica, and the per-client oracle (mark monotonicity +
    drain-to-exact-equality)."""

    def __init__(self, idx, mode, port, stop, dev):
        super().__init__(daemon=True, name=f"ab-{mode}-{idx:03d}")
        self.mode, self.port, self.stop = mode, port, stop
        self.pool = ConnectionPool()
        self.replica = engine_mod.init(0, device=dev)
        self.since = 0
        self.deliveries = 0
        self.violations = []
        self.errors = []

    def _req(self, path):
        resp, raw = self.pool.request(
            self.name, "server", "127.0.0.1", self.port,
            "GET", path, timeout=60)
        return resp.status, raw, {k: v for k, v in resp.getheaders()}

    def _apply(self, raw, hdr):
        nxt = int(hdr["X-Since-Next"])
        if nxt < self.since:
            self.violations.append(
                f"mark regressed {self.since} -> {nxt}")
        self.replica.apply(json_codec.loads(raw))
        fresh = nxt != self.since
        self.since = nxt
        return fresh

    def run(self):
        try:
            while not self.stop.is_set():
                if self.mode == "watch":
                    st, raw, hdr = self._req(
                        f"/docs/ab/watch?since={self.since}"
                        f"&limit=100000&timeout=1.0")
                    if st != 200:
                        self.errors.append(f"watch -> {st}")
                        return
                    if hdr["X-Watch-Event"] == "timeout":
                        continue
                    if self._apply(raw, hdr):
                        self.deliveries += 1
                else:
                    st, raw, hdr = self._req(
                        f"/docs/ab/ops?since={self.since}"
                        f"&limit=100000")
                    if st != 200:
                        self.errors.append(f"poll -> {st}")
                        return
                    if self._apply(raw, hdr):
                        self.deliveries += 1
                    self.stop.wait(POLL_INTERVAL_S)
            # drain to quiescence: the oracle needs every client
            # caught up before comparing replicas (not counted in the
            # delivery rate — both legs drain the same way)
            for _ in range(200):
                st, raw, hdr = self._req(
                    f"/docs/ab/ops?since={self.since}&limit=100000")
                if st != 200:
                    self.errors.append(f"drain -> {st}")
                    return
                before = self.since
                self._apply(raw, hdr)
                if self.since == before and \
                        hdr.get("X-Since-More") != "1":
                    return
        except OSError as e:
            self.errors.append(repr(e))
        finally:
            self.pool.close()


def _ab_leg(mode: str, dev=None) -> dict:
    engine = ServingEngine(device=dev)
    srv = make_server(port=0, store=engine)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    pool = ConnectionPool()
    try:
        def req(method, path, body=None):
            resp, raw = pool.request(
                "ab-writer", "server", "127.0.0.1", srv.server_port,
                method, path, body=body)
            return resp.status, raw

        st, raw = req("POST", "/docs/ab/ops", body=_chain(1, 4))
        assert st == 200 and json.loads(raw)["accepted"], raw
        stop = threading.Event()
        clients = [_ABClient(i, mode, srv.server_port, stop, dev)
                   for i in range(AB_CLIENTS)]
        for c in clients:
            c.start()
        t0 = time.monotonic()
        k, prev, commits = 0, 0, 0
        while time.monotonic() - t0 < AB_WALL_S:
            st, raw = req("POST", "/docs/ab/ops",
                          body=_chain(2, 4, start=k * 4 + 1,
                                      prev=prev))
            assert st == 200 and json.loads(raw)["accepted"], raw
            prev = 2 * 2**32 + (k + 1) * 4
            k += 1
            commits += 1
            time.sleep(WRITE_GAP_S)
        wall = time.monotonic() - t0
        stop.set()
        for c in clients:
            c.join(120)
        assert engine.flush(timeout=60)
        st, raw = req("GET", "/docs/ab")
        served = json.loads(raw)["values"]
        violations = [v for c in clients for v in c.violations]
        errors = [e for c in clients for e in c.errors]
        for c in clients:
            if c.replica.visible_values() != served:
                violations.append(
                    f"{c.name}: replica != served after drain")
        deliveries = sum(c.deliveries for c in clients)
        out = {
            "mode": mode, "clients": AB_CLIENTS, "commits": commits,
            "wall_s": round(wall, 3),
            "reads_delivered": deliveries,
            "reads_delivered_per_sec": round(deliveries / wall, 1),
            "errors": errors, "violations": violations,
        }
        if mode == "watch":
            d = engine.get("ab")
            out["server_watch"] = d.watch.stats.snapshot()
            out["server_watch"]["notify_ms"] = merge_notify_hists(
                [d.watch.stats.notify_ms.export()])
            rc = d.readcache.snapshot()
            out["readcache"] = {k: rc[k] for k in ("hits", "misses")}
        return out
    finally:
        pool.close()
        srv.shutdown()
        srv.server_close()
        engine.close()


def run(rounds: int = 3, out_path: str = None, device=None) -> dict:
    dev = _headline.resolve(device)
    audit0 = _headline.audit_mark()
    t0 = time.time()
    print("fan-out population:", flush=True)
    fanout = _fanout_population(dev=dev)
    print(f"  {fanout['watchers']} watchers, one encode "
          f"(misses +{fanout['readcache_misses_delta']}, hits "
          f"+{fanout['readcache_hits_delta']}), notify p99 "
          f"{fanout['notify_ms']['p99']} ms", flush=True)

    per_round = {leg: [] for leg in LEGS}
    for r in range(rounds):
        for leg in LEGS:            # interleaved: same host, same shape
            rep = _ab_leg(leg, dev)
            per_round[leg].append(rep)
            print(f"round {r} {leg}: "
                  f"{rep['reads_delivered_per_sec']} deliveries/s "
                  f"({rep['reads_delivered']} fresh windows, "
                  f"{rep['commits']} commits)", flush=True)
    best = {leg: max(per_round[leg],
                     key=lambda x: x["reads_delivered_per_sec"])
            for leg in LEGS}
    ratio = round(best["watch"]["reads_delivered_per_sec"]
                  / max(best["poll"]["reads_delivered_per_sec"],
                        1e-9), 3)
    violations = [v for leg in LEGS for x in per_round[leg]
                  for v in x["violations"]]
    errors = [e for leg in LEGS for x in per_round[leg]
              for e in x["errors"]]
    block = _headline.device_block(dev)
    out = {
        "bench": "fanout", "round": 1,
        "backend": _headline.platform_tag(block),
        "device": block,
        "flight_audit": _headline.audit_since(audit0),
        "config": {"watchers": WATCHERS, "ab_clients": AB_CLIENTS,
                   "ab_wall_s": AB_WALL_S,
                   "poll_interval_s": POLL_INTERVAL_S,
                   "write_gap_s": WRITE_GAP_S, "rounds": rounds,
                   "interleaved": True},
        "fanout": fanout,
        "legs": {leg: {"best": best[leg],
                       "all_rounds": [
                           {"reads_delivered_per_sec":
                                x["reads_delivered_per_sec"],
                            "reads_delivered": x["reads_delivered"],
                            "commits": x["commits"]}
                           for x in per_round[leg]]}
                 for leg in LEGS},
        "reads_delivered_per_sec_ratio": ratio,
        "gate": {"want": "watch >= 2x poll reads-delivered/s, "
                         "one cached encode per generation, "
                         "0 violations both legs",
                 "pass": ratio >= 2.0 and fanout["one_encode"]
                         and not violations},
        "violations_total": len(violations),
        "errors_total": len(errors),
        "wall_s": round(time.time() - t0, 1),
    }
    # written before the gates are asserted: a failed gate's measured
    # ratio is on record beside its threshold
    out_path = out_path or _headline.out_path("fanout")
    _headline.write(out, out_path)
    assert not errors, errors[:5]
    assert not violations, violations[:5]
    assert fanout["one_encode"], fanout
    _headline.speed_gate(out, ratio)
    print(f"PASS: watch {best['watch']['reads_delivered_per_sec']}"
          f"/s vs poll {best['poll']['reads_delivered_per_sec']}/s "
          f"(ratio {ratio}), notify p99 "
          f"{fanout['notify_ms']['p99']} ms -> {out_path}",
          flush=True)
    return out


def main(argv=None) -> int:
    device, argv = _headline.split_device(
        list(sys.argv[1:] if argv is None else argv))
    run(out_path=argv[0] if argv else None, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
