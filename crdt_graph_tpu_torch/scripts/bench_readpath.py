"""Read-path egress headline: what the per-snapshot encoded-body cache
buys on the read-heavy serving shape — the port's counterpart of
``scripts/bench_readpath.py``, merging on the card unless ``device``
names another.

Runs the SAME closed-loop session load (``bench/loadgen.py`` —
concurrent sessions against a real HTTP server over pooled keep-alive
connections, oracle-checked) on one host, one engine argument apart,
interleaved A/B per round:

- ``cached`` — ``ServingEngine(readcache=True)`` (default): every reader
  of a published generation gets the same cached ``bytes`` body
  (``serve/snapshot.py``), shipped as a memoryview;
- ``seed``   — ``ServingEngine(readcache=False)``: every ``GET
  /docs/{id}`` pays an O(doc) ``json.dumps`` over a fresh
  ``visible_values()`` copy (the reference's ``GRAFT_READCACHE=0``,
  an engine argument in the port).

The shape is read-heavy by construction: the ONE document is
PRELOADED with 64k values (a long-lived doc), then few sessions write
small deltas and poll ``reads_per_write`` times after every acked
write — so the wall is dominated by read egress over a big doc, which
is exactly the contrast under test.  Both legs run over the pooled
transport — the pool is NOT the A/B variable.

Reports per leg (best of ``rounds`` interleaved rounds): reads/s,
reader p50/p99, the readcache counters, the connection-pool counters,
and the oracle verdict (0 violations both legs or the run raises).
The gate: ``cached`` ≥ 2× ``seed`` reads/s OR ``seed`` p99 ≥ 2×
``cached`` p99.

Two side checks ride along:

- **wire identity** — one fixed write sequence served with the cache
  on and off must produce byte-identical ``GET /docs/{id}`` bodies,
  window bodies, ETags and ``X-Since-*`` headers (the cache is an
  egress optimization, never a wire change);
- **conditional polling** — a polling reader of an idle doc sends
  ``If-None-Match`` and must get straight 304s carrying
  ``X-Commit-Seq``, then a 200 with a NEW ETag after the next write.

Writes ``build/headline/BENCH_READPATH.json`` (or ``out_path``).  Run:
``python -m crdt_graph_tpu_torch.scripts.bench_readpath [rounds]
[--device cpu]``.
"""
from __future__ import annotations

import sys
import threading
import time

from . import _headline
from ..bench import loadgen
from ..cluster.pool import ConnectionPool
from ..codec import json_codec
from ..core.operation import Add, Batch
from ..obs import flight as flight_mod
from ..serve import ServingEngine
from ..service import make_server

LEGS = ("cached", "seed")
PRELOAD_OPS = 65_536
# the load's depth: sessions, acked writes each, reads after each write
N_SESSIONS = 8
WRITES_PER_SESSION = 10
READS_PER_WRITE = 10
_PRELOAD_BODY = None


def _cfg(dev=None) -> loadgen.LoadgenConfig:
    return loadgen.LoadgenConfig(
        n_sessions=N_SESSIONS, n_docs=1,
        writes_per_session=WRITES_PER_SESSION, delta_size=32,
        backspace_p=0.0, burst_fraction=0.0,
        reads_per_write=READS_PER_WRITE,
        max_queue_requests=256, stage_first_round=False, seed=15,
        device=dev)


def _preload_body() -> str:
    global _PRELOAD_BODY
    if _PRELOAD_BODY is None:
        _PRELOAD_BODY = _chain(99, PRELOAD_OPS)
    return _PRELOAD_BODY


def _one_leg(leg: str, cfg: loadgen.LoadgenConfig) -> dict:
    engine = ServingEngine(
        max_queue_requests=cfg.max_queue_requests,
        readcache=(leg == "cached"),
        flight=flight_mod.FlightRecorder(capacity=4096),
        device=cfg.device)
    try:
        # the long-lived doc: sessions (all on load0) read a document
        # that is ALREADY 64k values when traffic starts
        accepted, _ = engine.get("load0").apply_body(_preload_body())
        assert accepted
        rep = loadgen.run(cfg, engine=engine)
    finally:
        engine.close()
    if rep["oracle"]["violations_total"]:
        raise AssertionError(
            f"{leg}: session-guarantee violations under load: "
            f"{rep['violations'][:3]}")
    if rep["errors"]:
        raise AssertionError(f"{leg}: session errors: {rep['errors']}")
    return {"reads": rep["reads"],
            "reads_per_sec": rep["reads_per_sec"],
            "read_p50_ms": rep["read_p50_ms"],
            "read_p99_ms": rep["read_p99_ms"],
            "ops_per_sec": rep["ops_per_sec"],
            "load_wall_s": rep["load_wall_s"],
            "readcache": rep["readcache"],
            "connpool": rep["connpool"],
            "oracle_checks": sum(rep["oracle"]["checks"].values()),
            "violations": rep["oracle"]["violations_total"]}


def _chain(rid: int, n: int, start: int = 1, prev: int = 0) -> str:
    ops = []
    for c in range(start, start + n):
        ts = rid * 2**32 + c
        ops.append(Add(ts, (prev,), f"r{rid}:{c}"))
        prev = ts
    return json_codec.dumps(Batch(tuple(ops)))


def _wire_identity(dev=None) -> dict:
    """One fixed write sequence, cache on vs off: doc body, window
    body, ETag and the window's ``X-Since-*`` headers must be
    byte-identical."""
    out = {}
    for leg, enabled in (("cached", True), ("seed", False)):
        engine = ServingEngine(readcache=enabled, device=dev)
        srv = make_server(port=0, store=engine)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        pool = ConnectionPool()
        try:
            resp, raw = pool.request(
                "idcheck", "server", "127.0.0.1", srv.server_port,
                "POST", "/docs/ab/ops", body=_chain(9, 64))
            assert resp.status == 200, raw
            resp, body = pool.request(
                "idcheck", "server", "127.0.0.1", srv.server_port,
                "GET", "/docs/ab")
            resp2, wbody = pool.request(
                "idcheck", "server", "127.0.0.1", srv.server_port,
                "GET", "/docs/ab/ops?since=0&limit=16")
            out[leg] = {"doc_body": body, "window_body": wbody,
                        "etag": resp.getheader("ETag"),
                        "since": {k: v for k, v in resp2.getheaders()
                                  if k.startswith("X-Since-")}}
        finally:
            pool.close()
            srv.shutdown()
            srv.server_close()
            engine.close()
    return {
        "doc_body_identical":
            out["cached"]["doc_body"] == out["seed"]["doc_body"],
        "window_body_identical":
            out["cached"]["window_body"] == out["seed"]["window_body"],
        "etag_identical":
            out["cached"]["etag"] == out["seed"]["etag"],
        "since_headers_identical":
            bool(out["cached"]["since"])
            and out["cached"]["since"] == out["seed"]["since"],
        "doc_body_bytes": len(out["cached"]["doc_body"]),
    }


def _conditional_poll(polls: int = 50, dev=None) -> dict:
    """A polling reader of an idle doc: If-None-Match must answer 304
    (with X-Commit-Seq) every time, then 200 + a new ETag after the
    next write."""
    engine = ServingEngine(device=dev)
    srv = make_server(port=0, store=engine)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    pool = ConnectionPool()
    try:
        def req(method, path, body=None, headers=None):
            return pool.request("poller", "server", "127.0.0.1",
                                srv.server_port, method, path,
                                body=body, headers=headers)

        resp, raw = req("POST", "/docs/p/ops", body=_chain(3, 32))
        assert resp.status == 200, raw
        resp, body = req("GET", "/docs/p")
        etag = resp.getheader("ETag")
        n304 = 0
        seq_ok = True
        for _ in range(polls):
            resp, raw = req("GET", "/docs/p",
                            headers={"If-None-Match": etag})
            if resp.status == 304 and raw == b"":
                n304 += 1
            seq_ok = seq_ok and resp.getheader("X-Commit-Seq") is not None
        resp, raw = req("POST", "/docs/p/ops",
                        body=_chain(3, 1, start=33, prev=3 * 2**32 + 32))
        assert resp.status == 200
        resp, raw = req("GET", "/docs/p",
                        headers={"If-None-Match": etag})
        return {"polls": polls, "not_modified": n304,
                "headers_on_304": seq_ok,
                "write_invalidates":
                    resp.status == 200 and resp.getheader("ETag") != etag,
                "readcache": loadgen._aggregate_readcache(engine)}
    finally:
        pool.close()
        srv.shutdown()
        srv.server_close()
        engine.close()


def run(rounds: int = 3, out_path: str = None, device=None) -> dict:
    dev = _headline.resolve(device)
    audit0 = _headline.audit_mark()
    cfg = _cfg(dev)
    per_round = {leg: [] for leg in LEGS}
    t0 = time.time()
    for r in range(rounds):
        for leg in LEGS:            # interleaved: same host, same shape
            rep = _one_leg(leg, cfg)
            per_round[leg].append(rep)
            print(f"round {r} {leg}: {rep['reads_per_sec']} reads/s, "
                  f"p99 {rep['read_p99_ms']} ms", flush=True)
    best = {leg: max(per_round[leg], key=lambda x: x["reads_per_sec"])
            for leg in LEGS}
    p99 = {leg: min(x["read_p99_ms"] for x in per_round[leg])
           for leg in LEGS}
    ratio = round(best["cached"]["reads_per_sec"]
                  / max(best["seed"]["reads_per_sec"], 1e-9), 3)
    p99_ratio = round(p99["seed"] / max(p99["cached"], 1e-9), 3)
    identity = _wire_identity(dev)
    conditional = _conditional_poll(dev=dev)
    block = _headline.device_block(dev)
    out = {
        "bench": "readpath", "round": 1,
        "backend": _headline.platform_tag(block),
        "device": block,
        "flight_audit": _headline.audit_since(audit0),
        "config": {"sessions": cfg.n_sessions, "docs": cfg.n_docs,
                   "writes_per_session": cfg.writes_per_session,
                   "delta_size": cfg.delta_size,
                   "reads_per_write": cfg.reads_per_write,
                   "rounds": rounds, "interleaved": True},
        "legs": {leg: {"best": best[leg], "p99_best_ms": p99[leg],
                       "all_rounds": [
                           {"reads_per_sec": x["reads_per_sec"],
                            "read_p99_ms": x["read_p99_ms"]}
                           for x in per_round[leg]]}
                 for leg in LEGS},
        "reads_per_sec_ratio": ratio,
        "p99_ratio": p99_ratio,
        "gate": {"want": "reads/s >= 2x OR p99 halved",
                 "pass": ratio >= 2.0 or p99_ratio >= 2.0},
        "wire_identity": identity,
        "conditional_poll": conditional,
        "violations_total": sum(x["violations"]
                                for leg in LEGS for x in per_round[leg]),
        "wall_s": round(time.time() - t0, 1),
    }
    # written before the gates are asserted: a failed gate's measured
    # ratio is on record beside its threshold
    out_path = out_path or _headline.out_path("readpath")
    _headline.write(out, out_path)
    assert identity["doc_body_identical"] \
        and identity["window_body_identical"] \
        and identity["etag_identical"] \
        and identity["since_headers_identical"], identity
    assert conditional["not_modified"] == conditional["polls"], \
        conditional
    assert conditional["write_invalidates"], conditional
    assert out["violations_total"] == 0
    _headline.speed_gate(out, ratio, p99_ratio)
    print(f"wrote {out_path}: cached/seed reads/s ratio {ratio}x, "
          f"p99 ratio {p99_ratio}x", flush=True)
    return out


def main(argv=None) -> int:
    device, argv = _headline.split_device(
        list(sys.argv[1:] if argv is None else argv))
    run(rounds=int(argv[0]) if argv else 3, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
