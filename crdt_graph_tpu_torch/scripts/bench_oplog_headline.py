"""Cascade op-log headline: bounded memory + checkpoint+tail restore for
a long-lived config-5-scale document, measured honestly — the port's
counterpart of ``scripts/bench_oplog_headline.py``, its merges on the
card unless ``device`` names another.

Shape: the 64-replica × 1M-op chain-merge document (bench config 5),
ingested the way the serving engine ingests a long-lived doc — bounded
kernel chunks — with the cascade at its DEFAULT knobs
(GRAFT_OPLOG_HOT_OPS=32768, GC on).  Reports:

- **resident op-log bytes**, untiered vs tiered-after-spill, priced by
  the one shared estimator (``oplog._packed_resident``): the untiered
  side counts the full packed column set, its value table, and the
  ts→pos index the first ``/ops?since=`` pull builds; the tiered side
  counts the hot tail, the cold add indexes, and the (empty at measure
  time) segment cache.
- **restore**, at two milestones against the full chunked replay:
  (a) SERVING-READY — the restored tree answers a correct anti-entropy
  window (tier descriptors + indexes, no materialization) vs the replay
  reaching the same point, and (b) + FIRST READ — one full merge
  materializes the document.  The merge fingerprint (replica-independent
  ``state_fingerprint``) must be BIT-IDENTICAL across original /
  restored / replayed.
- **sync-window latency** off the published view: steady-state hot-tail
  windows and cold mid-history windows (first touch pays one segment
  load through the LRU; repeats hit cache).

Writes ``build/headline/BENCH_OPLOG.json`` (or ``out_path``).  Run:
``python -m crdt_graph_tpu_torch.scripts.bench_oplog_headline
[out_path] [--device cpu]``.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

from . import _headline
from .. import engine
from .. import oplog as oplog_mod
from ..bench import workloads
from ..codec import packed as packed_mod
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


def _pctl(xs, q):
    if not xs:
        return None
    xs = sorted(xs)
    return round(xs[min(len(xs) - 1, int(q * len(xs)))], 3)


def run(out_path: str = None,
        n_ops: int = 1_000_000, hot_ops: int = HOT_OPS,
        device=None) -> dict:
    dev = _headline.resolve(device)
    p = _workload(n_ops)
    n = p.num_ops
    tier_dir = tempfile.mkdtemp(prefix="graft-bench-oplog-")

    # -- warmup: one untimed chunked ingest of the first two chunks
    # loads the kernels and primes the allocator, so BOTH timed ingests
    # below measure steady-state work (there are no compile buckets to
    # fill here, unlike the JAX reference's full warm ingest)
    warm = engine.init(0, device=dev)
    warm.apply_packed_chunked(_workload(min(n_ops, 2 * CHUNK)), CHUNK)
    del warm

    # -- untiered twin: what the pre-cascade serving path kept -----------
    flat = engine.init(0, device=dev)
    t0 = time.perf_counter()
    flat.apply_packed_chunked(p, CHUNK)
    ingest_flat_s = time.perf_counter() - t0
    p_flat = flat.packed_state()
    # first anti-entropy pull builds the full ts→pos index
    packed_mod.packed_since_bytes(p_flat, int(p.ts[n - 8]))
    untiered_resident = oplog_mod._packed_resident(p_flat)

    # -- tiered serving-shaped ingest (default knobs) ---------------------
    tiered = engine.init(0, device=dev)
    tiered.enable_log_tiering(tier_dir, hot_ops=hot_ops)
    t0 = time.perf_counter()
    tiered.apply_packed_chunked(p, CHUNK)
    ingest_tiered_s = time.perf_counter() - t0
    tele = tiered._log.telemetry()
    tiered_resident = tiered._log.resident_bytes()
    ratio = tiered_resident / untiered_resident

    snap_orig = snapshot_mod.derive("doc", 0, tiered)
    snap_flat = snapshot_mod.derive("doc", 0, flat)
    fp = snap_orig.state_fingerprint()
    fps_equal = fp == snap_flat.state_fingerprint()

    # -- restore: checkpoint + tail vs full replay ------------------------
    t0 = time.perf_counter()
    tiered.checkpoint_tiered(tier_dir)
    checkpoint_s = time.perf_counter() - t0

    # restore milestone 1 — SERVING-READY: the tree can answer
    # anti-entropy windows (the fleet-rejoin scenario: a restored
    # replica starts syncing immediately; windows resolve from the
    # tier descriptors and indexes with no materialization)
    probe_ts = int(p.ts[n - 8])
    t0 = time.perf_counter()
    restored = engine.TpuTree.restore_tiered(tier_dir, device=dev)
    body, meta = restored.log_view().window(probe_ts, 4096)
    restore_serving_s = time.perf_counter() - t0
    assert meta["found"]
    # restore milestone 2 — FIRST READ: one full merge materializes
    # the document (every restore path pays this lazily, including
    # the pre-cascade restore_packed)
    t0 = time.perf_counter()
    restored_values = restored.visible_values()
    restore_first_read_s = time.perf_counter() - t0

    # the pre-cascade bootstrap: full chunked replay of the whole
    # history; sync windows are only correct once the replay finishes
    t0 = time.perf_counter()
    replayed = engine.init(0, device=dev)
    replayed.apply_packed_chunked(p, CHUNK)
    body2, meta2 = replayed.log_view().window(probe_ts, 4096)
    replay_serving_s = time.perf_counter() - t0
    assert meta2["found"] and body2 == body
    t0 = time.perf_counter()
    replayed_values = replayed.visible_values()
    replay_first_read_s = time.perf_counter() - t0
    replay_s = replay_serving_s + replay_first_read_s

    snap_r = snapshot_mod.derive("doc", 0, restored)
    snap_p = snapshot_mod.derive("doc", 0, replayed)
    fps_equal = fps_equal and \
        snap_r.state_fingerprint() == fp and \
        snap_p.state_fingerprint() == fp and \
        restored_values == replayed_values
    restore_total_s = restore_serving_s + restore_first_read_s
    speedup_serving = replay_serving_s / restore_serving_s \
        if restore_serving_s else None
    speedup_read = replay_s / restore_total_s if restore_total_s \
        else None

    # -- sync-window serving latency off the published view ---------------
    view = tiered.log_view()
    rng = np.random.default_rng(7)
    hot_ms, cold_first_ms, cold_warm_ms = [], [], []
    hot_marks = rng.integers(n - hot_ops // 2, n - 1, size=200)
    for i in hot_marks:
        ts = int(p.ts[i])
        t0 = time.perf_counter()
        body, meta = view.window(ts, 4096)
        hot_ms.append((time.perf_counter() - t0) * 1e3)
        assert meta["found"], ts
    cold_marks = rng.integers(1, n // 2, size=60)
    for k, i in enumerate(cold_marks):
        ts = int(p.ts[i])
        t0 = time.perf_counter()
        body, meta = view.window(ts, 4096)
        (cold_first_ms if k < 30 else cold_warm_ms).append(
            (time.perf_counter() - t0) * 1e3)
        assert meta["found"], ts

    block = _headline.device_block(dev)
    out = {
        "bench": "oplog_cascade_headline",
        "rev": "r01",
        "host": _headline.platform_tag(block),
        "device": block,
        "n_ops": n,
        "knobs": {"hot_ops": hot_ops, "chunk_ops": CHUNK,
                  "gc_min_segs": int(os.environ.get(
                      "GRAFT_OPLOG_GC_SEGS", 4))},
        "ingest_s": {"tiered": round(ingest_tiered_s, 3),
                     "untiered": round(ingest_flat_s, 3)},
        "tiers": {k: tele[k] for k in
                  ("hot_ops", "cold_ops", "base_ops", "segments",
                   "spills", "compactions", "segments_gc",
                   "cold_file_bytes", "base_file_bytes")},
        "resident": {
            "untiered_bytes": int(untiered_resident),
            "tiered_bytes": int(tiered_resident),
            "ratio": round(ratio, 4),
            "accounting": "oplog._packed_resident: columns + sampled "
                          "value table + ts-index; tiered = hot tail "
                          "+ cold add indexes + segment cache",
        },
        "restore": {
            "checkpoint_s": round(checkpoint_s, 3),
            "serving_ready_s": round(restore_serving_s, 4),
            "first_read_s": round(restore_first_read_s, 3),
            "total_s": round(restore_total_s, 3),
            "replay_serving_ready_s": round(replay_serving_s, 3),
            "replay_total_s": round(replay_s, 3),
            "speedup_serving_ready": round(speedup_serving, 1)
            if speedup_serving else None,
            "speedup_to_first_read": round(speedup_read, 2)
            if speedup_read else None,
        },
        "windows": {
            "hot_p50_ms": _pctl(hot_ms, 0.50),
            "hot_p99_ms": _pctl(hot_ms, 0.99),
            "cold_first_p50_ms": _pctl(cold_first_ms, 0.50),
            "cold_warm_p50_ms": _pctl(cold_warm_ms, 0.50),
        },
        "fingerprints_equal": bool(fps_equal),
        "state_fingerprint": fp,
    }
    _headline.write(out, out_path or _headline.out_path("oplog"))
    print(json.dumps(out, indent=2))
    return out


def main(argv=None) -> int:
    device, argv = _headline.split_device(
        list(sys.argv[1:] if argv is None else argv))
    run(*argv[:1], device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
