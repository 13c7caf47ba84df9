"""Cold-path cost collapse headline: every cold path costs what it
touches, measured honestly on the config-5 shapes — the port's
counterpart of ``scripts/bench_coldpath_headline.py``, its merges on
the card unless ``device`` names another.

Three legs, one output (``build/headline/BENCH_COLDPATH.json``):

- **restore-to-first-read A/B** — the 1M-op config-5 document is
  checkpointed WITH its materialization artifact, then restored with
  ``use_matz`` on vs off in interleaved rounds (same host, same files,
  best-of per leg).  The "off" leg re-merges the whole history at the
  first read.  Reference gate: ≥5× on restore+first-read, fingerprints
  bit-identical across original / matz / no-matz.
- **mid-history catch-up window** — the same 1M ops folded into a
  CHUNKED checkpoint base (default ``GRAFT_OPLOG_BASE_CHUNK_OPS``) vs a
  monolithic one (forced via a huge chunk size).  Each first-touch
  window starts from a cleared segment cache, so the measured cost is
  what a cold catch-up really pays: one covering chunk vs the whole
  base — in both latency and resident cache bytes.
- **many-doc fleet fsyncs/round** — the 64-doc loadgen shape (closed
  loop, oracle-checked) under the per-doc WAL vs the shared stream
  (``wal_shared``).  Reference gate: ≥8× fewer fsyncs per scheduler
  round at equal-or-better acked throughput, zero oracle violations
  both legs.

Run: ``python -m crdt_graph_tpu_torch.scripts.bench_coldpath_headline
[out_path] [--device cpu]``.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

from . import _headline
from .. import engine
from .. import oplog as oplog_mod
from ..bench import loadgen
from ..bench import workloads
from ..codec import packed as packed_mod
from ..obs import flight as flight_mod
from ..serve import ServingEngine
from ..serve import snapshot as snapshot_mod

CHUNK = 1 << 17          # the serving engine's default kernel chunk
HOT_OPS = 32768          # the cascade's default hot budget


def _workload(n_ops: int) -> packed_mod.PackedOps:
    arrs = workloads.chain_workload(n_replicas=64, n_ops=n_ops)
    n = int(arrs["kind"].shape[0])
    return packed_mod.PackedOps(
        kind=arrs["kind"], ts=arrs["ts"],
        parent_ts=arrs["parent_ts"], anchor_ts=arrs["anchor_ts"],
        depth=arrs["depth"], paths=arrs["paths"],
        value_ref=arrs["value_ref"], pos=arrs["pos"],
        values=[f"v{i}" for i in range(n)], num_ops=n,
        parent_pos=arrs["parent_pos"], anchor_pos=arrs["anchor_pos"],
        target_pos=arrs["target_pos"], ts_rank=arrs["ts_rank"],
        hints_vouched=True)


def _restore_leg(ckpt_dir: str, use_matz: bool, dev) -> dict:
    t0 = time.perf_counter()
    r = engine.TpuTree.restore_tiered(ckpt_dir, use_matz=use_matz,
                                      device=dev)
    serving_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    values = r.visible_values()
    first_read_s = time.perf_counter() - t0
    fp = snapshot_mod.derive("doc", 0, r).state_fingerprint()
    return {"serving_ready_s": round(serving_s, 4),
            "first_read_s": round(first_read_s, 4),
            "total_s": round(serving_s + first_read_s, 4),
            "matz_stats": dict(r.matz_stats),
            "fingerprint": fp,
            "n_visible": len(values)}


def _catchup_leg(p: packed_mod.PackedOps, dirname: str,
                 base_chunk_ops: int, marks, limit: int = 4096
                 ) -> dict:
    log = oplog_mod.OpLog()
    log.extend_packed(p)
    log.enable_tiering(dirname, hot_ops=HOT_OPS, gc_min_segs=1,
                       base_chunk_ops=base_chunk_ops)
    log.maybe_spill()
    log.set_stable_mark(len(log))
    log.run_gc()
    tele = log.telemetry()
    view = log.view(1)
    first_ms, warm_ms = [], []
    cache_high = 0
    for ts in marks:
        log._cache.clear()          # every mark is a genuine cold read
        t0 = time.perf_counter()
        body, meta = view.window(ts, limit)
        first_ms.append((time.perf_counter() - t0) * 1e3)
        assert meta["found"], ts
        cache_high = max(cache_high, log.telemetry()["cache_bytes"])
        t0 = time.perf_counter()
        view.window(ts, limit)
        warm_ms.append((time.perf_counter() - t0) * 1e3)
    return {"base_chunks": tele["segments"]["base"],
            "base_ops": tele["base_ops"],
            "first_touch_ms": [round(v, 2) for v in first_ms],
            "first_touch_p50_ms": round(sorted(first_ms)[
                len(first_ms) // 2], 2),
            "warm_p50_ms": round(sorted(warm_ms)[len(warm_ms) // 2], 2),
            "cache_bytes_high": int(cache_high)}


def _fleet_leg(shared: bool, n_docs: int, n_sessions: int,
               writes_per_session: int, seed: int, dev) -> dict:
    ddir = tempfile.mkdtemp(prefix=f"coldpath-{'sh' if shared else 'pd'}-")
    eng = ServingEngine(max_queue_requests=64,
                        durable_dir=ddir, wal_sync="batch",
                        wal_shared=shared,
                        flight=flight_mod.FlightRecorder(), device=dev)
    try:
        cfg = loadgen.LoadgenConfig(
            n_sessions=n_sessions, n_docs=n_docs,
            writes_per_session=writes_per_session, delta_size=8,
            max_queue_requests=64, giant_ops=0,
            stage_first_round=True, seed=seed, device=dev)
        rep = loadgen.run(cfg, engine=eng)
        rounds = max(1, eng.scheduler._rounds_completed)
        fsyncs = rep["wal"]["fsyncs"]
        out = {
            "mode": "shared" if shared else "perdoc",
            "writes_acked": rep["writes_acked"],
            "load_wall_s": rep["load_wall_s"],
            "acked_writes_per_s": round(
                rep["writes_acked"] / rep["load_wall_s"], 1),
            "ack_p50_ms": rep["ack_p50_ms"],
            "ack_p99_ms": rep["ack_p99_ms"],
            "fsyncs": fsyncs,
            "scheduler_rounds": rounds,
            "fsyncs_per_round": round(fsyncs / rounds, 2),
            "oracle_checks": sum(rep["oracle"]["checks"].values()),
            "violations": rep["oracle"]["violations_total"],
        }
        if shared and rep.get("wal_shared"):
            cov = rep["wal_shared"]["covered_docs"]
            out["covered_docs_per_fsync_mean"] = round(
                cov["sum"] / max(1, cov["count"]), 1) if cov else None
        if rep["oracle"]["violations_total"]:
            raise AssertionError(
                f"fleet leg ({out['mode']}): oracle violations "
                f"{rep['violations']!r}")
        return out
    finally:
        eng.close()
        shutil.rmtree(ddir, ignore_errors=True)


def run(out_path: str = None,
        n_ops: int = 1_000_000, restore_rounds: int = 2,
        fleet_docs: int = 64, fleet_sessions: int = 64,
        fleet_writes: int = 4, fleet_rounds: int = 2,
        device=None) -> dict:
    dev = _headline.resolve(device)
    audit0 = _headline.audit_mark()
    p = _workload(n_ops)
    n = p.num_ops
    work = tempfile.mkdtemp(prefix="graft-bench-coldpath-")
    ckpt = os.path.join(work, "ckpt")

    # warmup (two chunks): the kernels loaded and the allocator primed
    # before anything is timed (no compile buckets to fill here, unlike
    # the JAX reference's full warm ingest)
    warm = engine.init(0, device=dev)
    warm.apply_packed_chunked(_workload(min(n_ops, 2 * CHUNK)), CHUNK)
    del warm

    tiered = engine.init(0, device=dev)
    tiered.enable_log_tiering(os.path.join(work, "live"),
                              hot_ops=HOT_OPS)
    t0 = time.perf_counter()
    tiered.apply_packed_chunked(p, CHUNK)
    ingest_s = time.perf_counter() - t0
    fp0 = snapshot_mod.derive("doc", 0, tiered).state_fingerprint()
    t0 = time.perf_counter()
    tiered.checkpoint_tiered(ckpt)
    checkpoint_s = time.perf_counter() - t0
    with open(os.path.join(ckpt, "manifest.json")) as f:
        assert json.load(f).get("matz") is not None, \
            "checkpoint did not persist the materialization artifact"

    # -- leg 1: restore-to-first-read, interleaved A/B --------------------
    legs = {"matz": [], "nomatz": []}
    for _ in range(restore_rounds):
        legs["matz"].append(_restore_leg(ckpt, True, dev))
        legs["nomatz"].append(_restore_leg(ckpt, False, dev))
    best = {k: min(v, key=lambda g: g["total_s"])
            for k, v in legs.items()}
    fps = {fp0} | {g["fingerprint"] for v in legs.values() for g in v}
    fingerprints_equal = len(fps) == 1
    speedup = best["nomatz"]["total_s"] / best["matz"]["total_s"]
    assert best["matz"]["matz_stats"]["loads"] == 1
    assert best["matz"]["matz_stats"]["fallbacks"] == 0

    # -- leg 2: mid-history catch-up windows, chunked vs monolith ---------
    marks = [int(p.ts[i]) for i in (n // 4, n // 2, (3 * n) // 4)]
    chunked = _catchup_leg(p, os.path.join(work, "cbase"),
                           base_chunk_ops=131072, marks=marks)
    monolith = _catchup_leg(p, os.path.join(work, "mbase"),
                            base_chunk_ops=1 << 62, marks=marks)
    catchup = {
        "chunked": chunked,
        "monolith": monolith,
        "first_touch_speedup": round(
            monolith["first_touch_p50_ms"]
            / chunked["first_touch_p50_ms"], 1),
        "resident_ratio": round(
            chunked["cache_bytes_high"]
            / max(1, monolith["cache_bytes_high"]), 4),
    }

    # -- leg 3: many-doc fleet fsyncs/round, per-doc vs shared ------------
    fleet = {"perdoc": [], "shared": []}
    for r in range(fleet_rounds):
        fleet["perdoc"].append(_fleet_leg(
            False, fleet_docs, fleet_sessions, fleet_writes,
            seed=31 + r, dev=dev))
        fleet["shared"].append(_fleet_leg(
            True, fleet_docs, fleet_sessions, fleet_writes,
            seed=31 + r, dev=dev))
    fbest = {k: max(v, key=lambda g: g["acked_writes_per_s"])
             for k, v in fleet.items()}
    fsync_reduction = (fbest["perdoc"]["fsyncs_per_round"]
                       / max(0.01, fbest["shared"]["fsyncs_per_round"]))

    block = _headline.device_block(dev)
    out = {
        "bench": "coldpath_headline",
        "rev": "r01",
        "host": _headline.platform_tag(block),
        "device": block,
        "flight_audit": _headline.audit_since(audit0),
        "at": time.strftime("%Y-%m-%d %H:%M:%S"),
        "n_ops": n,
        "knobs": {"hot_ops": HOT_OPS, "chunk_ops": CHUNK,
                  "base_chunk_ops": 131072,
                  "fleet": {"docs": fleet_docs,
                            "sessions": fleet_sessions,
                            "writes_per_session": fleet_writes}},
        "ingest_s": round(ingest_s, 3),
        "checkpoint_s": round(checkpoint_s, 3),
        "restore": {
            "best": best,
            "all_rounds": legs,
            "speedup_to_first_read": round(speedup, 2),
        },
        "catchup": catchup,
        "fleet": {
            "best": fbest,
            "all_rounds": fleet,
            "fsyncs_per_round_reduction": round(fsync_reduction, 1),
            "shared_vs_perdoc_throughput": round(
                fbest["shared"]["acked_writes_per_s"]
                / fbest["perdoc"]["acked_writes_per_s"], 3),
        },
        "fingerprints_equal": bool(fingerprints_equal),
        "state_fingerprint": fp0,
    }
    shutil.rmtree(work, ignore_errors=True)
    _headline.write(out, out_path or _headline.out_path("coldpath"))
    print(json.dumps(out, indent=2))
    return out


def main(argv=None) -> int:
    device, argv = _headline.split_device(
        list(sys.argv[1:] if argv is None else argv))
    run(*argv[:1], device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
