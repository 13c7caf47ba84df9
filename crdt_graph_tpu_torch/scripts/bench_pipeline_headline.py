"""Pipelined-commit headline: what overlapping group-commit fsync with
merge compute — and moving tier maintenance (spill/fold/matz export/WAL
compaction) to the background worker — buys on the many-doc durable
serving shape; the port's counterpart of
``scripts/bench_pipeline_headline.py``, merging on the card unless
``device`` names another.

Runs the SAME closed-loop session load (``bench/loadgen.py`` —
concurrent sessions against a real HTTP server, oracle-checked) on one
host, one engine knob apart, interleaved A/B per round:

- ``pipelined``  — ``ServingEngine(pipeline=True)`` (default): round
  N+1's fuse+merge compute runs while round N's fsyncs are in flight on
  the WAL-sync worker, and every O(doc-state) maintenance job rides the
  maintenance lane (``serve/workers.py``);
- ``serialized`` — ``ServingEngine(pipeline=False)``: every round pays
  compute + fsync + maintenance in series (the reference's
  ``GRAFT_PIPELINE=0``, an engine argument in the port).

The shape is the 64-doc group-commit stress: many per-doc WAL fsync
streams per round (fsync wall time rivals merge compute), a small
hot-tail budget so spills are constant, and a small matz cadence so
artifact exports land mid-run (the serialized leg pays them between
rounds on the ack path — visible as ack p99/max spikes).

Reports acked-writes/s per leg (best of ``rounds`` interleaved rounds),
the ratio ``pipelined / serialized``, ack p50/p99/max per leg, the
ack-latency breakdown (compute vs fsync-queue vs fsync), and the
maintenance/pipeline worker stats — all oracle-verified (0 violations
both legs or the run raises).

Writes ``build/headline/BENCH_PIPELINE.json`` (or ``out_path``).  Run:
``python -m crdt_graph_tpu_torch.scripts.bench_pipeline_headline
[out_path] [--device cpu]``.
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

from . import _headline
from ..bench import loadgen
from ..obs import flight as flight_mod
from ..serve import ServingEngine

LEGS = ("pipelined", "serialized")


def _one_leg(leg: str, cfg: loadgen.LoadgenConfig, *,
             hot_ops: int, matz_tail_ops: int) -> dict:
    ddir = tempfile.mkdtemp(prefix=f"pipebench-{leg}-")
    prev_matz = os.environ.get("GRAFT_MATZ_TAIL_OPS")
    os.environ["GRAFT_MATZ_TAIL_OPS"] = str(matz_tail_ops)
    try:
        engine = ServingEngine(
            max_queue_requests=cfg.max_queue_requests,
            durable_dir=ddir, wal_sync="batch",
            oplog_hot_ops=hot_ops,
            pipeline=(leg == "pipelined"),
            flight=flight_mod.FlightRecorder(capacity=4096),
            device=cfg.device)
        try:
            rep = loadgen.run(cfg, engine=engine)
        finally:
            engine.close()
            shutil.rmtree(ddir, ignore_errors=True)
    finally:
        if prev_matz is None:
            os.environ.pop("GRAFT_MATZ_TAIL_OPS", None)
        else:
            os.environ["GRAFT_MATZ_TAIL_OPS"] = prev_matz
    if rep["oracle"]["violations_total"]:
        raise AssertionError(
            f"{leg}: oracle violations {rep['violations']!r}")
    if rep["errors"]:
        raise AssertionError(f"{leg}: session errors {rep['errors']}")
    read_ms = rep["read_p99_ms"]
    return {
        "leg": leg,
        "writes_acked": rep["writes_acked"],
        "leaves_acked": rep["leaves_acked"],
        "load_wall_s": rep["load_wall_s"],
        "acked_writes_per_s": round(
            rep["writes_acked"] / rep["load_wall_s"], 1),
        "acked_leaves_per_s": round(
            rep["leaves_acked"] / rep["load_wall_s"], 1),
        "ack_p50_ms": rep["ack_p50_ms"],
        "ack_p99_ms": rep["ack_p99_ms"],
        "read_p50_ms": rep["read_p50_ms"],
        "read_p99_ms": read_ms,
        "shed_429": rep["shed_429"],
        "wal": rep["wal"],
        "ack_breakdown_ms": rep["ack_breakdown_ms"],
        "pipeline": rep["pipeline"],
        "maint": ({k: v for k, v in rep["maint"].items()
                   if k not in ("task_ms",)}
                  if rep["maint"] else None),
        "oracle_checks": sum(rep["oracle"]["checks"].values()),
        "violations": rep["oracle"]["violations_total"],
    }


def run(out_path: str = None,
        n_sessions: int = 64, n_docs: int = 64,
        writes_per_session: int = 6, delta_size: int = 256,
        hot_ops: int = 32, matz_tail_ops: int = 512,
        rounds: int = 3, device=None) -> dict:
    dev = _headline.resolve(device)
    audit0 = _headline.audit_mark()
    legs: dict = {m: [] for m in LEGS}
    t0 = time.time()
    for r in range(rounds):
        for leg in LEGS:
            cfg = loadgen.LoadgenConfig(
                n_sessions=n_sessions, n_docs=n_docs,
                writes_per_session=writes_per_session,
                delta_size=delta_size,
                max_queue_requests=64, giant_ops=0,
                stage_first_round=False, seed=23 + r, device=dev)
            out = _one_leg(leg, cfg, hot_ops=hot_ops,
                           matz_tail_ops=matz_tail_ops)
            out["round"] = r
            legs[leg].append(out)
            print(f"[bench_pipeline] round {r} {leg}: "
                  f"{out['acked_writes_per_s']} acked-writes/s, "
                  f"ack p50 {out['ack_p50_ms']} ms "
                  f"p99 {out['ack_p99_ms']} ms", flush=True)
    best = {m: max(legs[m], key=lambda g: g["acked_writes_per_s"])
            for m in LEGS}
    speedup = (best["pipelined"]["acked_writes_per_s"]
               / best["serialized"]["acked_writes_per_s"])
    block = _headline.device_block(dev)
    out = {
        "bench": "pipeline_headline",
        "at": time.strftime("%Y-%m-%d %H:%M:%S"),
        "host_platform": _headline.platform_tag(block),
        "device": block,
        "flight_audit": _headline.audit_since(audit0),
        "shape": {"sessions": n_sessions, "docs": n_docs,
                  "writes_per_session": writes_per_session,
                  "delta_size": delta_size, "hot_ops": hot_ops,
                  "matz_tail_ops": matz_tail_ops,
                  "wal_sync": "batch", "rounds": rounds},
        "best": best,
        "all_rounds": legs,
        # the acceptance number: pipelined acked throughput over the
        # serialized baseline, same host, interleaved A/B
        "pipelined_vs_serialized_speedup": round(speedup, 3),
        # the matz-spike story: the serialized leg's tail carries the
        # inline artifact exports; the pipelined leg moved them to
        # the maintenance worker
        "ack_p99_serialized_ms": best["serialized"]["ack_p99_ms"],
        "ack_p99_pipelined_ms": best["pipelined"]["ack_p99_ms"],
        "wall_s": round(time.time() - t0, 1),
    }
    out_path = out_path or _headline.out_path("pipeline")
    _headline.write(out, out_path)
    print(f"[bench_pipeline] pipelined-vs-serialized speedup "
          f"{speedup:.2f}x; wrote {out_path}", flush=True)
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
