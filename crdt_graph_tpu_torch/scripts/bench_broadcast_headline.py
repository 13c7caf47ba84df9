"""Broadcast headline: reactor vs threaded watch delivery, same host,
interleaved A/B — how many watchers one host can PARK, and what one
commit's broadcast costs at that population; the port's counterpart of
``scripts/bench_broadcast_headline.py``, its server merging on the card
unless ``device`` names another.

Three leg shapes, every leg the same client machinery (subprocess
drivers over raw keep-alive sockets — the parent process holds only
the server, so its RSS/thread census is the SERVER bill):

- ``threaded@N``  — ``ServingEngine(reactor=False)``: every parked
  watcher pins a handler thread (the reference's ``GRAFT_REACTOR=0``,
  an engine argument in the port).  N defaults to 1,000.
- ``reactor@N``   — the selector tier parks the same population on
  ≤ 4 loop threads: the apples-to-apples notify-latency comparison.
- ``reactor@BIG`` — the capacity leg (default 10,000): the population
  the threaded path cannot hold, parked flat, then broadcast to.

Each leg: park everyone at one mark, then ``ROUNDS`` commits; after
every commit the parent waits for the whole population to deliver AND
re-park (the server registry is the barrier — no client-side clock
skew).  Children verify per delivery: event taxonomy, marks strictly
advance, and one body hash per generation across every socket of
every child (the single-flight encode made visible on the wire).  The
drivers run this file as a script with ``--child`` and import nothing
but the standard library (no ``torch``, no CUDA context per driver):
the dispatch sits above every other import.

Headline numbers per leg: watchers parked, park wall, server RSS per
watcher, server thread count at steady state, notify p50/p99 across
all deliveries, broadcast amplification (delivered op·watchers/s:
ops-per-commit × population / round wall).

Gate: reactor parks ≥ 3× the threaded population with notify p99 at
the A/B population equal-or-better, zero violations and zero errors
on every leg.  A wire-identity check rides along: one fixed write
sequence's watch deliveries (resume, notify, timeout heartbeat) are
byte-identical between the two park paths, modulo the ``Date`` stamp.
Writes ``build/headline/BENCH_BROADCAST.json`` (or ``out_path``).
Run: ``python -m crdt_graph_tpu_torch.scripts.bench_broadcast_headline
[out_path] [--device cpu]``.
"""
from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import sys
import threading
import time

OPS_PER_COMMIT = 8


def _read_response(sock: socket.socket, timeout: float = 300.0):
    """One Content-Length framed keep-alive response: ``(head bytes,
    lower-cased headers, body)``.  Stdlib-only: the child drivers use
    this before any heavy import exists in their interpreter."""
    sock.settimeout(timeout)
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("eof before headers")
        buf += chunk
    head, _, rest = buf.partition(b"\r\n\r\n")
    hdrs = {}
    for ln in head.split(b"\r\n")[1:]:
        k, _, v = ln.partition(b": ")
        hdrs[k.decode().lower()] = v.decode()
    clen = int(hdrs.get("content-length", "0"))
    while len(rest) < clen:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("eof before body")
        rest += chunk
    return head, hdrs, rest[:clen]


def _read_http(sock: socket.socket, timeout: float = 300.0):
    """One keep-alive response: ``(status, headers, body)``."""
    head, hdrs, body = _read_response(sock, timeout)
    return int(head.split(b"\r\n", 1)[0].split()[1]), hdrs, body


def _child_main(argv) -> int:
    """One client driver: COUNT raw keep-alive watchers parked at one
    mark, ROUNDS deliveries each, verification inline, stats JSON on
    stdout.  Runs on stdlib alone — no package import, so a fleet of
    drivers starts in milliseconds."""
    port, doc, since0, count, rounds = (int(argv[0]), argv[1],
                                        int(argv[2]), int(argv[3]),
                                        int(argv[4]))

    def line(since: int) -> bytes:
        return (f"GET /docs/{doc}/watch?since={since}&limit=100000"
                f"&timeout=600 HTTP/1.1\r\nHost: bench\r\n\r\n"
                ).encode()

    socks, marks = [], []
    stats = {"count": count, "deliveries": 0, "bytes_rx": 0,
             "rounds": [], "violations": [], "errors": []}
    try:
        for _ in range(count):
            s = socket.create_connection(("127.0.0.1", port),
                                         timeout=120)
            s.sendall(line(since0))
            socks.append(s)
            marks.append(since0)
        for r in range(rounds):
            rhash = None
            for i, s in enumerate(socks):
                try:
                    status, hdrs, body = _read_http(s)
                except (OSError, ConnectionError) as e:
                    stats["errors"].append(f"r{r} s{i}: {e!r}")
                    continue
                if status != 200:
                    stats["errors"].append(f"r{r} s{i} -> {status}")
                    continue
                ev = hdrs.get("x-watch-event")
                if ev != "notify":
                    stats["violations"].append(
                        f"r{r} s{i}: event {ev}, not notify")
                nxt = int(hdrs.get("x-since-next", marks[i]))
                if nxt <= marks[i]:
                    stats["violations"].append(
                        f"r{r} s{i}: mark {marks[i]} -> {nxt}")
                marks[i] = nxt
                h = hashlib.sha1(body).hexdigest()
                if rhash is None:
                    rhash = h
                elif h != rhash:
                    stats["violations"].append(
                        f"r{r} s{i}: body hash diverged")
                stats["deliveries"] += 1
                stats["bytes_rx"] += len(body)
                if r + 1 < rounds:
                    s.sendall(line(nxt))
            stats["rounds"].append({"hash": rhash,
                                    "mark": marks[0] if marks else 0})
    finally:
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
    print(json.dumps(stats))
    return 0


if __name__ == "__main__" and len(sys.argv) > 1 \
        and sys.argv[1] == "--child":
    sys.exit(_child_main(sys.argv[2:]))

from . import _headline  # noqa: E402
from ..cluster.pool import ConnectionPool  # noqa: E402
from ..codec import json_codec  # noqa: E402
from ..core.operation import Add, Batch  # noqa: E402
from ..serve import ServingEngine  # noqa: E402
from ..serve.watch import merge_notify_hists  # noqa: E402
from ..service import make_server  # noqa: E402

THREADED_WATCHERS = int(os.environ.get("BB_THREADED_WATCHERS", "1000"))
AB_WATCHERS = int(os.environ.get("BB_AB_WATCHERS", "1000"))
BIG_WATCHERS = int(os.environ.get("BB_BIG_WATCHERS", "10000"))
ROUNDS = int(os.environ.get("BB_ROUNDS", "3"))
REPEATS = int(os.environ.get("BB_REPEATS", "2"))
CHILDREN = int(os.environ.get("BB_CHILDREN", "4"))


def _chain(rid: int, n: int, start: int = 1, prev: int = 0) -> str:
    ops = []
    for c in range(start, start + n):
        ts = rid * 2**32 + c
        ops.append(Add(ts, (prev,), f"r{rid}:{c}"))
        prev = ts
    return json_codec.dumps(Batch(tuple(ops)))


def _vmrss_kb() -> int:
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("VmRSS:"):
                return int(ln.split()[1])
    return 0


def _leg(mode: str, n: int, rounds: int = None,
         children: int = None, dev=None) -> dict:
    """Park ``n`` watchers under ``mode``'s delivery tier, broadcast
    ``rounds`` commits (default ``ROUNDS``) through them from
    ``children`` drivers (default ``CHILDREN``), bill the server."""
    rounds = ROUNDS if rounds is None else rounds
    children = CHILDREN if children is None else children
    reactor_on = mode == "reactor"
    engine = ServingEngine(reactor=reactor_on, watch_max=n + 1024,
                           device=dev)
    srv = make_server(port=0, store=engine)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    pool = ConnectionPool()
    procs = []
    try:
        def req(method, path, body=None):
            resp, raw = pool.request(
                "bench-main", "server", "127.0.0.1", srv.server_port,
                method, path, body=body, timeout=120)
            return resp.status, raw, {k: v
                                      for k, v in resp.getheaders()}

        st, raw, _ = req("POST", "/docs/bb/ops", body=_chain(1, 8))
        assert st == 200 and json.loads(raw)["accepted"], raw
        st, _, hdr = req("GET", "/docs/bb/ops?since=0&limit=100000")
        mark = int(hdr["X-Since-Next"])
        d = engine.get("bb")
        d.watch.park_s = 900.0

        rss0 = _vmrss_kb()
        thr0 = threading.active_count()
        ws0 = d.watch.stats.snapshot()
        rc0 = d.readcache.snapshot()

        t_park0 = time.monotonic()
        per = [n // children + (1 if i < n % children else 0)
               for i in range(children)]
        for cnt in per:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--child",
                 str(srv.server_port), "bb", str(mark), str(cnt),
                 str(rounds)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))

        def wait_parked(target, timeout=600.0):
            deadline = time.monotonic() + timeout
            while d.watch.counts()["parked"] < target:
                assert time.monotonic() < deadline, \
                    (mode, n, d.watch.counts())
                time.sleep(0.02)

        wait_parked(n)
        park_wall = time.monotonic() - t_park0
        rss_parked = _vmrss_kb()
        thr_parked = threading.active_count()
        rsnap = engine.reactor.snapshot() if reactor_on else None

        def wait_round(r):
            # The barrier after commit ``r``: every watcher DELIVERED
            # (stale parks still count toward ``parked``, so the
            # notify counter is the real signal) and, unless this was
            # the final generation, every watcher re-parked — the
            # next commit must never race a straggler's re-park or it
            # would fold two generations into one window.
            deadline = time.monotonic() + 600.0
            while True:
                ns = d.watch.stats.snapshot()["notifies"] \
                    - ws0["notifies"]
                if ns >= n * (r + 1) and (
                        r + 1 == rounds
                        or d.watch.counts()["parked"] >= n):
                    return
                assert time.monotonic() < deadline, \
                    (mode, n, r, ns, d.watch.counts())
                time.sleep(0.02)

        round_walls = []
        for r in range(rounds):
            t0 = time.monotonic()
            st, raw, _ = req(
                "POST", "/docs/bb/ops",
                body=_chain(2, OPS_PER_COMMIT,
                            start=r * OPS_PER_COMMIT + 1,
                            prev=0 if r == 0
                            else 2 * 2**32 + r * OPS_PER_COMMIT))
            assert st == 200 and json.loads(raw)["accepted"], raw
            wait_round(r)
            round_walls.append(time.monotonic() - t0)
        for p in procs:               # last round: drivers drain out
            p.wait(timeout=600)

        child_stats = []
        for p in procs:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err[-2000:]
            child_stats.append(json.loads(out))
        violations = [v for c in child_stats for v in c["violations"]]
        errors = [e for c in child_stats for e in c["errors"]]
        # one wire body per generation across EVERY driver
        for r in range(rounds):
            hashes = {c["rounds"][r]["hash"] for c in child_stats}
            if len(hashes) != 1:
                violations.append(f"round {r}: {len(hashes)} distinct "
                                  f"bodies across drivers")
        deliveries = sum(c["deliveries"] for c in child_stats)
        if deliveries != n * rounds:
            errors.append(f"deliveries {deliveries} != {n * rounds}")

        ws1 = d.watch.stats.snapshot()
        rc1 = d.readcache.snapshot()
        nm = merge_notify_hists([d.watch.stats.notify_ms.export()])
        bcast_wall = sum(round_walls)
        out = {
            "mode": mode,
            "watchers": n,
            "rounds": rounds,
            "child_drivers": children,
            "park_wall_s": round(park_wall, 3),
            "rss_parked_delta_kb": rss_parked - rss0,
            "rss_per_watcher_kb": round((rss_parked - rss0) / n, 2),
            "threads_baseline": thr0,
            "threads_parked": thr_parked,
            "threads_parked_delta": thr_parked - thr0,
            "reactor": ({"threads": rsnap["threads"],
                         "parked": rsnap["parked"],
                         "detached": rsnap["detached"],
                         "partial_writes": rsnap["partial_writes"],
                         "buf_hw": rsnap["buf_hw"]}
                        if rsnap is not None else None),
            "round_walls_s": [round(w, 3) for w in round_walls],
            "deliveries": deliveries,
            "delivered_windows_per_sec": round(
                deliveries / bcast_wall, 1),
            "broadcast_amplification_opwatchers_per_sec": round(
                OPS_PER_COMMIT * deliveries / bcast_wall, 1),
            "notify_ms": nm,
            "server_notifies": ws1["notifies"] - ws0["notifies"],
            "readcache_misses_delta": rc1["misses"] - rc0["misses"],
            "readcache_hits_delta": rc1["hits"] - rc0["hits"],
            "bytes_rx": sum(c["bytes_rx"] for c in child_stats),
            "violations": violations,
            "errors": errors,
            "registered_after": d.watch.counts()["registered"],
        }
        assert out["server_notifies"] == deliveries, \
            (out["server_notifies"], deliveries)
        # the single-flight encode, amortized: at most the caught-up
        # terminator window + the delivery window per generation miss,
        # while the population rides hits
        assert out["readcache_misses_delta"] <= 2 * rounds + 2, out
        assert out["readcache_hits_delta"] >= rounds * (n - 1), out
        if reactor_on:
            assert rsnap["threads"] <= 4, rsnap
            assert out["threads_parked_delta"] <= 32, out
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        pool.close()
        srv.shutdown()
        srv.server_close()
        engine.close()


def _norm_head(head: bytes) -> bytes:
    """The ``Date`` stamp is the one permitted difference between the
    two park paths' responses."""
    return b"\r\n".join(ln for ln in head.split(b"\r\n")
                         if not ln.startswith(b"Date: "))


def _wire_identity(dev=None) -> dict:
    """One fixed write sequence served by each park path over one raw
    keep-alive socket: the resume, the notify and the timeout heartbeat
    responses (status line, headers, body) must be byte-identical."""
    got = {}
    for mode in ("reactor", "threaded"):
        engine = ServingEngine(reactor=(mode == "reactor"), device=dev)
        srv = make_server(port=0, store=engine)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        pool = ConnectionPool()
        s = socket.create_connection(("127.0.0.1", srv.server_port),
                                     timeout=60)
        try:
            def post(body):
                resp, raw = pool.request(
                    "idcheck", "server", "127.0.0.1", srv.server_port,
                    "POST", "/docs/id/ops", body=body)
                assert resp.status == 200 and \
                    json.loads(raw)["accepted"], raw

            def watch(since, timeout):
                s.sendall((f"GET /docs/id/watch?since={since}"
                           f"&limit=100000&timeout={timeout} HTTP/1.1\r\n"
                           f"Host: bench\r\nX-Session-Id: sess-id-0001"
                           f"\r\n\r\n").encode())

            post(_chain(1, 8))
            doc = engine.get("id")
            legs = {}
            watch(0, 5)
            legs["resume"] = _read_response(s, 60)
            mark = int(legs["resume"][1]["x-since-next"])
            watch(mark, 30)
            deadline = time.monotonic() + 30
            while doc.watch.counts()["parked"] < 1:
                assert time.monotonic() < deadline, "never parked"
                time.sleep(0.005)
            post(_chain(2, OPS_PER_COMMIT))
            legs["notify"] = _read_response(s, 60)
            mark = int(legs["notify"][1]["x-since-next"])
            watch(mark, 0.2)
            legs["timeout"] = _read_response(s, 60)
            got[mode] = {k: (_norm_head(v[0]), v[2])
                         for k, v in legs.items()}
        finally:
            s.close()
            pool.close()
            srv.shutdown()
            srv.server_close()
            engine.close()
    return {"legs": sorted(got["reactor"]),
            "identical": got["reactor"] == got["threaded"],
            "events": {k: _read_event(v[0])
                       for k, v in got["threaded"].items()}}


def _read_event(head: bytes) -> str:
    for ln in head.split(b"\r\n"):
        if ln.lower().startswith(b"x-watch-event: "):
            return ln.split(b": ", 1)[1].decode()
    return "?"


def run(out_path: str = None, device=None) -> dict:
    dev = _headline.resolve(device)
    audit0 = _headline.audit_mark()
    t0 = time.time()
    identity = _wire_identity(dev)
    print(f"wire identity (reactor vs threaded): {identity}", flush=True)
    ab = {"threaded": [], "reactor": []}
    for rep in range(REPEATS):
        for mode, n in (("threaded", THREADED_WATCHERS),
                        ("reactor", AB_WATCHERS)):
            leg = _leg(mode, n, dev=dev)
            ab[mode].append(leg)
            print(f"A/B rep {rep} {mode}@{n}: notify p99 "
                  f"{leg['notify_ms']['p99']} ms, "
                  f"{leg['delivered_windows_per_sec']} deliveries/s, "
                  f"rss/watcher {leg['rss_per_watcher_kb']} kB, "
                  f"threads +{leg['threads_parked_delta']}",
                  flush=True)
    print(f"capacity leg: reactor@{BIG_WATCHERS}", flush=True)
    big = _leg("reactor", BIG_WATCHERS, dev=dev)
    print(f"  parked {big['watchers']} in {big['park_wall_s']}s on "
          f"{big['reactor']['threads']} loop thread(s), threads "
          f"+{big['threads_parked_delta']}, notify p99 "
          f"{big['notify_ms']['p99']} ms, amplification "
          f"{big['broadcast_amplification_opwatchers_per_sec']} "
          f"op·watchers/s", flush=True)

    best = {m: min(ab[m], key=lambda x: x["notify_ms"]["p99"])
            for m in ab}
    p99_ratio = round(best["reactor"]["notify_ms"]["p99"]
                      / max(best["threaded"]["notify_ms"]["p99"],
                            1e-9), 3)
    capacity_ratio = round(big["watchers"]
                           / best["threaded"]["watchers"], 2)
    violations = [v for legs in ab.values() for x in legs
                  for v in x["violations"]] + big["violations"]
    errors = [e for legs in ab.values() for x in legs
              for e in x["errors"]] + big["errors"]
    block = _headline.device_block(dev)
    out = {
        "bench": "broadcast", "round": 1,
        "backend": _headline.platform_tag(block),
        "device": block,
        "flight_audit": _headline.audit_since(audit0),
        "wire_identity": identity,
        "config": {"threaded_watchers": THREADED_WATCHERS,
                   "ab_watchers": AB_WATCHERS,
                   "big_watchers": BIG_WATCHERS,
                   "rounds": ROUNDS, "repeats": REPEATS,
                   "child_drivers": CHILDREN,
                   "ops_per_commit": OPS_PER_COMMIT,
                   "interleaved": True},
        "ab": {m: {"best": best[m],
                   "all_rounds": [
                       {"notify_p99_ms": x["notify_ms"]["p99"],
                        "delivered_windows_per_sec":
                            x["delivered_windows_per_sec"],
                        "rss_per_watcher_kb":
                            x["rss_per_watcher_kb"],
                        "threads_parked_delta":
                            x["threads_parked_delta"]}
                       for x in ab[m]]}
               for m in ab},
        "capacity": big,
        "notify_p99_ratio_reactor_over_threaded": p99_ratio,
        "watchers_per_host_ratio": capacity_ratio,
        "rss_per_watcher_ratio_threaded_over_reactor": round(
            best["threaded"]["rss_per_watcher_kb"]
            / max(best["reactor"]["rss_per_watcher_kb"], 1e-9), 2),
        "gate": {"want": ">=3x watchers-per-host, notify p99 at the "
                         "A/B population equal-or-better, 0 "
                         "violations every leg",
                 "pass": capacity_ratio >= 3.0 and p99_ratio <= 1.0
                         and not violations and not errors},
        "violations_total": len(violations),
        "errors_total": len(errors),
        "wall_s": round(time.time() - t0, 1),
    }
    # written before the gates are asserted: a failed gate's measured
    # ratio is on record beside its threshold
    out_path = out_path or _headline.out_path("broadcast")
    _headline.write(out, out_path)
    assert identity["identical"], identity
    assert not errors, errors[:5]
    assert not violations, violations[:5]
    _headline.speed_gate(out, capacity_ratio, p99_ratio)
    print(f"PASS: {capacity_ratio}x watchers-per-host "
          f"({big['watchers']} reactor vs "
          f"{best['threaded']['watchers']} threaded), notify p99 "
          f"{best['reactor']['notify_ms']['p99']} vs "
          f"{best['threaded']['notify_ms']['p99']} ms "
          f"(ratio {p99_ratio}), rss/watcher "
          f"{best['reactor']['rss_per_watcher_kb']} vs "
          f"{best['threaded']['rss_per_watcher_kb']} kB "
          f"-> {out_path}", flush=True)
    return out


def main(argv=None) -> int:
    device, argv = _headline.split_device(
        list(sys.argv[1:] if argv is None else argv))
    run(out_path=argv[0] if argv else None, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
