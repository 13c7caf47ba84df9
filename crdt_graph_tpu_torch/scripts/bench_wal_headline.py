"""WAL durability-tax headline: what fsync-before-ack costs on the
loadgen serving shape, measured honestly — the port's counterpart of
``scripts/bench_wal_headline.py``, merging on the card unless
``device`` names another.

Runs the SAME closed-loop session load (``bench/loadgen.py`` —
concurrent editor/burst sessions against a real HTTP server,
oracle-checked) three times on one host, one engine config apart:

- ``off``   — durable tier dirs, no WAL (acked hot-tail ops die with
  the process);
- ``batch`` — group-commit WAL (default): one fsync per document per
  scheduler round covers every coalesced ticket;
- ``commit`` — one fsync per commit, the strictest policy.

Reports acked-writes/s + acked-leaves/s and ack p50/p99 per mode, the
fsync counts (batch must amortize: fsyncs ≤ commits), and the headline
regression ``batch vs off`` on acked throughput (the reference bounds
it at ≤ 25 %).  ``rounds`` repeats the full off/batch/commit cycle and
keeps the best (max acked-ops/s) leg per mode.

Writes ``build/headline/BENCH_WAL.json`` (or ``out_path``).  Run:
``python -m crdt_graph_tpu_torch.scripts.bench_wal_headline [out_path]
[--device cpu]``.
"""
from __future__ import annotations

import shutil
import sys
import tempfile
import time

from . import _headline
from ..bench import loadgen
from ..obs import flight as flight_mod
from ..serve import ServingEngine

MODES = ("off", "batch", "commit")


def _one_leg(mode: str, cfg: loadgen.LoadgenConfig) -> dict:
    ddir = tempfile.mkdtemp(prefix=f"walbench-{mode}-")
    engine = ServingEngine(
        max_queue_requests=cfg.max_queue_requests,
        durable_dir=ddir, wal_sync=mode,
        flight=flight_mod.FlightRecorder(), device=cfg.device)
    try:
        rep = loadgen.run(cfg, engine=engine)
    finally:
        engine.close()
        shutil.rmtree(ddir, ignore_errors=True)
    if rep["oracle"]["violations_total"]:
        raise AssertionError(
            f"{mode}: oracle violations {rep['violations']!r}")
    if rep["errors"]:
        raise AssertionError(f"{mode}: session errors {rep['errors']}")
    return {
        "mode": mode,
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
        "read_p99_ms": rep["read_p99_ms"],
        "shed_429": rep["shed_429"],
        "wal": rep["wal"],
        "oracle_checks": sum(rep["oracle"]["checks"].values()),
        "violations": rep["oracle"]["violations_total"],
    }


def run(out_path: str = None,
        n_sessions: int = 24, n_docs: int = 4,
        writes_per_session: int = 12, delta_size: int = 24,
        rounds: int = 3, device=None) -> dict:
    dev = _headline.resolve(device)
    audit0 = _headline.audit_mark()
    legs: dict = {m: [] for m in MODES}
    t0 = time.time()
    for r in range(rounds):
        for mode in MODES:
            cfg = loadgen.LoadgenConfig(
                n_sessions=n_sessions, n_docs=n_docs,
                writes_per_session=writes_per_session,
                delta_size=delta_size,
                max_queue_requests=64, giant_ops=0,
                stage_first_round=(r == 0), seed=17 + r, device=dev)
            leg = _one_leg(mode, cfg)
            leg["round"] = r
            legs[mode].append(leg)
            print(f"[bench_wal] round {r} {mode}: "
                  f"{leg['acked_writes_per_s']} acked-writes/s, "
                  f"ack p50 {leg['ack_p50_ms']} ms "
                  f"p99 {leg['ack_p99_ms']} ms", flush=True)
    best = {m: max(legs[m], key=lambda g: g["acked_writes_per_s"])
            for m in MODES}
    reg = 1.0 - (best["batch"]["acked_writes_per_s"]
                 / best["off"]["acked_writes_per_s"])
    block = _headline.device_block(dev)
    out = {
        "bench": "wal_headline",
        "at": time.strftime("%Y-%m-%d %H:%M:%S"),
        "host_platform": _headline.platform_tag(block),
        "device": block,
        "flight_audit": _headline.audit_since(audit0),
        "shape": {"sessions": n_sessions, "docs": n_docs,
                  "writes_per_session": writes_per_session,
                  "delta_size": delta_size, "rounds": rounds},
        "best": best,
        "all_rounds": legs,
        # the acceptance number: batch-mode acked-throughput
        # regression vs the no-WAL baseline (negative = noise gave
        # the durable leg the better run)
        "batch_vs_off_regression": round(reg, 4),
        "commit_vs_off_regression": round(
            1.0 - (best["commit"]["acked_writes_per_s"]
                   / best["off"]["acked_writes_per_s"]), 4),
        "wall_s": round(time.time() - t0, 1),
    }
    out_path = out_path or _headline.out_path("wal")
    _headline.write(out, out_path)
    print(f"[bench_wal] batch-vs-off regression "
          f"{out['batch_vs_off_regression']:+.1%}; wrote {out_path}",
          flush=True)
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
