"""Storage-floor headline: what the completion-driven fsync fan-out,
the host-shared body cache, and zero-copy cold egress buy, measured
honestly on one host — the port's counterpart of
``scripts/bench_storfloor.py``, merging on the card unless ``device``
names another.

Three legs, one JSON (``build/headline/BENCH_STORFLOOR.json``):

1. **Sync backend A/B** — the SAME 64-doc ``wal_sync="batch"``
   closed-loop loadgen shape (``bench/loadgen.py``: concurrent
   editor/burst sessions over real HTTP, oracle-checked), interleaved
   single→auto→single→auto on one host so drift hits both lanes
   equally; best-of per backend.  The headline is the **fsync stall
   share of ack p99** (fsync_queue + fsync_wait summed per commit — the
   serialized lane books its convoy in the queue stage, a
   completion-driven lane in the wait stage, so only the sum is
   backend-fair).  The reference asks for a ≥2x share cut; an
   anti-result is reported as measured, with the resolved backend and
   the queue/wait split labeled.
2. **Shared-memory fleet leg** — ``serve_smoke.run_fleet_procs``: 3
   REAL processes x 4 generations; the exact ledger (misses +1 per
   generation host-wide, hits +(N-1), zero degradations, zero leaks)
   is asserted inside and re-recorded here.
3. **Zero-copy egress leg** — sealed cold segments served over real
   HTTP with the default ``GRAFT_SENDFILE``; every window byte-compared
   to the buffered snapshot truth across the full resumable chain,
   ETags included.  Identity is asserted, throughput recorded.

Every leg runs its convergence/identity oracle; the output reports 0
violations or the bench dies loudly.  Run: ``python -m
crdt_graph_tpu_torch.scripts.bench_storfloor [out_path] [--device
cpu]``.
"""
from __future__ import annotations

import shutil
import sys
import tempfile
import threading
import time

from . import _headline
from ..bench import loadgen
from ..codec import json_codec
from ..core.operation import Add, Batch
from ..obs import flight as flight_mod
from ..serve import ServingEngine

BACKENDS = ("single", "auto")


def _sync_leg(backend: str, cfg: loadgen.LoadgenConfig) -> dict:
    ddir = tempfile.mkdtemp(prefix=f"storfloor-{backend}-")
    engine = ServingEngine(
        max_queue_requests=cfg.max_queue_requests,
        durable_dir=ddir, wal_sync="batch",
        wal_sync_backend=backend, pipeline=True,
        flight=flight_mod.FlightRecorder(), device=cfg.device)
    try:
        rep = loadgen.run(cfg, engine=engine)
    finally:
        engine.close()
        shutil.rmtree(ddir, ignore_errors=True)
    if rep["oracle"]["violations_total"]:
        raise AssertionError(
            f"{backend}: oracle violations {rep['violations']!r}")
    if rep["errors"]:
        raise AssertionError(f"{backend}: session errors "
                             f"{rep['errors']}")
    bd = rep["ack_breakdown_ms"]
    stall = bd.get("fsync_stall") or {}
    share = (round(stall["p99"] / rep["ack_p99_ms"], 4)
             if stall.get("p99") and rep["ack_p99_ms"] else None)
    return {
        "backend_requested": backend,
        "backend_resolved": bd["sync_backend"],
        "writes_acked": rep["writes_acked"],
        "acked_writes_per_s": round(
            rep["writes_acked"] / rep["load_wall_s"], 1),
        "ack_p50_ms": rep["ack_p50_ms"],
        "ack_p99_ms": rep["ack_p99_ms"],
        "fsync_wait_ms": bd.get("fsync_wait"),
        "fsync_queue_ms": bd.get("fsync_queue"),
        "fsync_stall_ms": stall or None,
        "fsync_stall_share_p99": share,
        "wal_fsyncs": rep["wal"]["fsyncs"],
        "oracle_checks": sum(rep["oracle"]["checks"].values()),
        "violations": rep["oracle"]["violations_total"],
    }


def _chain(counter, anchor, n):
    ops = []
    for _ in range(n):
        counter += 1
        t = (1 << 32) + counter
        ops.append(Add(t, (anchor,), counter & 0xFF))
        anchor = t
    return ops, counter, anchor


def _sendfile_leg(dev) -> dict:
    """Fill cold tiers, serve the full resumable window chain over
    real HTTP, byte-compare every window (body + ETag + cursor)
    against the buffered snapshot truth."""
    from http.client import HTTPConnection

    from ..service.http import make_server

    eng = ServingEngine(oplog_hot_ops=8, device=dev)
    assert eng.sendfile_stats is not None, "GRAFT_SENDFILE off?"
    counter, anchor = 0, 0
    for _ in range(40):
        ops, counter, anchor = _chain(counter, anchor, 4)
        ok, _ = eng.submit("d", json_codec.dumps(Batch(tuple(ops))))
        assert ok
    srv = make_server(port=0, store=eng)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]

    def get(path, headers=None):
        c = HTTPConnection("127.0.0.1", port, timeout=10)
        c.request("GET", path, headers=headers or {})
        r = c.getresponse()
        body = r.read()
        hdrs = {k.lower(): v for k, v in r.getheaders()}
        c.close()
        return r.status, body, hdrs

    try:
        # warm: first pulls queue the sidecar builds
        deadline = time.time() + 20
        while not eng.sendfile_stats.get("windows"):
            st, _b, _h = get("/docs/d/ops?since=0&limit=16")
            assert st == 200
            if time.time() > deadline:
                raise AssertionError(
                    f"sendfile never served: "
                    f"{eng.sendfile_stats.snapshot()}")
            time.sleep(0.05)
        snap = eng.get("d").snapshot_view()
        since, windows, mismatches, t0 = 0, 0, 0, time.time()
        while True:
            bbody, bmeta = snap.ops_since_window(since, 16)
            st, zbody, zh = get(f"/docs/d/ops?since={since}&limit=16")
            assert st == 200
            if zbody != bbody or zh["etag"] != bmeta["etag"]:
                mismatches += 1
            windows += 1
            if not bmeta["more"]:
                break
            since = bmeta["next_since"]
        wall = time.time() - t0
        assert mismatches == 0, f"{mismatches} windows diverged"
        stats = eng.sendfile_stats.snapshot()
    finally:
        srv.shutdown()
        eng.close()
    return {
        "windows_compared": windows,
        "byte_identical": True,
        "windows_zero_copy": stats.get("windows", 0),
        "file_bytes": stats.get("file_bytes", 0),
        "fallbacks": stats.get("fallback", 0),
        "sidecar_builds": stats.get("sidecar_builds", 0),
        "chain_wall_s": round(wall, 3),
        "violations": 0,
    }


def _shm_leg(dev) -> dict:
    from . import serve_smoke
    out = serve_smoke.run_fleet_procs(n_procs=3, gens=4, device=dev)
    out["violations"] = 0        # the ledger asserts inside
    return out


def _median(vals):
    vals = sorted(v for v in vals if v is not None)
    return vals[len(vals) // 2] if vals else None


def run(out_path: str = None,
        n_sessions: int = 64, n_docs: int = 64,
        writes_per_session: int = 8, delta_size: int = 12,
        rounds: int = 3, device=None) -> dict:
    dev = _headline.resolve(device)
    audit0 = _headline.audit_mark()
    t0 = time.time()
    legs: dict = {b: [] for b in BACKENDS}
    for r in range(rounds):
        for backend in BACKENDS:            # interleaved A/B
            cfg = loadgen.LoadgenConfig(
                n_sessions=n_sessions, n_docs=n_docs,
                writes_per_session=writes_per_session,
                delta_size=delta_size,
                max_queue_requests=128, giant_ops=0,
                stage_first_round=(r == 0), seed=29 + r, device=dev)
            leg = _sync_leg(backend, cfg)
            leg["round"] = r
            legs[backend].append(leg)
            print(f"[storfloor] round {r} {backend} "
                  f"(resolved {leg['backend_resolved']}): "
                  f"ack p99 {leg['ack_p99_ms']} ms, fsync_stall share "
                  f"{leg['fsync_stall_share_p99']}", flush=True)
    best = {b: max(legs[b], key=lambda g: g["acked_writes_per_s"])
            for b in BACKENDS}
    # the share is a ratio of two noisy p99s — median across the
    # interleaved rounds, not the best-throughput leg's draw
    shares = {b: _median([g["fsync_stall_share_p99"] for g in legs[b]])
              for b in BACKENDS}
    s_single, s_fanout = shares["single"], shares["auto"]
    share_cut = (round(s_single / s_fanout, 2)
                 if s_single and s_fanout else None)
    shm = _shm_leg(dev)
    print(f"[storfloor] shm fleet: {shm}", flush=True)
    sendfile = _sendfile_leg(dev)
    print(f"[storfloor] sendfile: {sendfile}", flush=True)
    block = _headline.device_block(dev)
    out = {
        "bench": "storfloor_headline",
        "at": time.strftime("%Y-%m-%d %H:%M:%S"),
        "host_platform": _headline.platform_tag(block),
        "device": block,
        "flight_audit": _headline.audit_since(audit0),
        "shape": {"sessions": n_sessions, "docs": n_docs,
                  "writes_per_session": writes_per_session,
                  "delta_size": delta_size, "rounds": rounds,
                  "wal_sync": "batch"},
        "sync_backend_ab": {
            "best": best, "all_rounds": legs,
            "median_stall_share": shares,
            # the acceptance number: the per-doc durability stall's
            # share of ack p99 (fsync_queue + fsync_wait summed per
            # commit), serialized lane vs completion-driven fan-out.
            # > 1.0 = the fan-out cut the stall share by that factor;
            # an anti-result is committed as measured, with the
            # queue/wait split above telling the per-stage story
            "fsync_stall_share_cut": share_cut},
        "shm_fleet": shm,
        "sendfile": sendfile,
        "wall_s": round(time.time() - t0, 1),
    }
    out_path = out_path or _headline.out_path("storfloor")
    _headline.write(out, out_path)
    print(f"[storfloor] fsync_stall share cut "
          f"{share_cut}x; wrote {out_path}", flush=True)
    return out


def main(argv=None) -> int:
    device, argv = _headline.split_device(
        list(sys.argv[1:] if argv is None else argv))
    kw = {"device": device}
    if argv:
        kw["out_path"] = argv[0]
    run(**kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
