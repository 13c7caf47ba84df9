"""Concurrent-serving workload: the serving engine under mixed traffic.

Unlike the kernel benches (runner.py: one merge, honest device timing),
this measures the SERVING layer end to end, in process (no socket noise):
W writer threads push randomized deltas to M documents through the
scheduler while R reader threads hammer snapshot reads, and one
bootstrap-size push lands mid-run to prove reads don't stall behind a
big merge.  Reported: reader latency percentiles (the snapshot-isolation
headline), commit latency, coalesce width, scheduler span stats, and
the flight-recorder counters (every bench commit leaves a traced record
behind — obs/flight.py — so a pathological bench round ships its own
post-mortem dump).

The engine merges on the caller's device (the card unless
``device`` names another; it raises without one): the bootstrap push
and the writers' grouped rounds launch the kernels there.

Usage: ``python -m crdt_graph_tpu_torch.bench.serving [--device cpu]
[docs] [seconds]`` (defaults 4 docs, 5 s).  Emits one JSON line.
"""
from __future__ import annotations

import json
import threading
import time
from typing import List

from ..codec import json_codec
from ..core.operation import Add, Batch
from ..serve import ServingEngine

OFFSET = 2**32


def _delta(replica: int, counter: int, anchor: int, size: int) -> tuple:
    """A causally valid chain delta: ``size`` adds from ``replica``
    anchored at ``anchor`` (0 = document head)."""
    ops = []
    prev = anchor
    for _ in range(size):
        counter += 1
        ts = replica * OFFSET + counter
        ops.append(Add(ts, (prev,), counter % 997))
        prev = ts
    return Batch(tuple(ops)), counter, prev


def run(n_docs: int = 4, seconds: float = 5.0, writers_per_doc: int = 4,
        readers: int = 8, delta_size: int = 32,
        bootstrap_ops: int = 100_000, device=None) -> dict:
    engine = ServingEngine(device=device)
    stop = threading.Event()
    read_lat_ms: List[float] = []
    lat_lock = threading.Lock()
    errors: List[str] = []

    doc_ids = [f"bench{i}" for i in range(n_docs)]
    for d in doc_ids:
        engine.get(d)

    def writer(doc_id: str, replica: int):
        counter = 0
        anchor = 0
        while not stop.is_set():
            delta, counter, anchor = _delta(replica, counter, anchor,
                                            delta_size)
            try:
                accepted, _ = engine.submit(doc_id,
                                            json_codec.dumps(delta))
                if not accepted:
                    errors.append("rejected")
            except Exception as e:          # noqa: BLE001 — bench report
                errors.append(repr(e))
                return

    def reader():
        i = 0
        local: List[float] = []
        while not stop.is_set():
            doc = engine.get(doc_ids[i % n_docs], create=False)
            i += 1
            t0 = time.perf_counter()
            snap = doc.snapshot_view()
            _ = len(snap.values)
            _ = snap.clock_wire()
            local.append((time.perf_counter() - t0) * 1e3)
            if i % 50 == 0:
                time.sleep(0)               # yield
        with lat_lock:
            read_lat_ms.extend(local)

    threads = [threading.Thread(target=writer, args=(d, 1 + w), daemon=True)
               for d in doc_ids for w in range(writers_per_doc)]
    threads += [threading.Thread(target=reader, daemon=True)
                for _ in range(readers)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()

    # mid-run bootstrap push: a big chain lands on doc 0 while readers
    # run; its named trace id is how the flight record for THIS push is
    # found among the coalesced interactive traffic
    big, _, _ = _delta(99, 0, 0, bootstrap_ops)
    t0 = time.perf_counter()
    engine.submit(doc_ids[0], json_codec.dumps(big),
                  trace_id="bench-bootstrap-push")
    bootstrap_s = time.perf_counter() - t0
    # grab the bootstrap commit's flight record NOW: it lands
    # asynchronously just after the ticket resolves, and the bounded
    # ring (default capacity 256) evicts it long before the run ends
    # under interactive traffic
    boot_rec = None
    boot_deadline = time.perf_counter() + 10.0
    while boot_rec is None and time.perf_counter() < boot_deadline:
        boot_rec = next(
            (r for r in engine.flight.records()
             if "bench-bootstrap-push" in r.trace_ids), None)
        if boot_rec is None:
            time.sleep(0.05)

    while time.perf_counter() - t_start < seconds:
        time.sleep(0.05)
    stop.set()
    for t in threads:
        t.join(10)
    wall_s = time.perf_counter() - t_start

    read_lat_ms.sort()
    n = len(read_lat_ms)
    merged = sum(engine.get(d).ops_merged for d in doc_ids)
    out = {
        "bench": "serving",
        "docs": n_docs,
        "writers": n_docs * writers_per_doc,
        "readers": readers,
        "device": str(engine.device),
        "wall_s": wall_s,
        "ops_merged": merged,
        "merge_ops_per_sec": merged / wall_s,
        "reads": n,
        "read_p50_ms": read_lat_ms[n // 2] if n else None,
        "read_p99_ms": read_lat_ms[(99 * n) // 100] if n else None,
        "read_max_ms": read_lat_ms[-1] if n else None,
        "bootstrap_ops": bootstrap_ops,
        "bootstrap_commit_s": bootstrap_s,
        "errors": errors[:5],
        "scheduler": engine.scheduler_metrics(),
        "doc0_metrics": engine.get(doc_ids[0]).metrics(),
    }
    engine.close()
    # after close the scheduler is joined: the recorder holds every
    # commit.  Report its counters plus the bootstrap push's own
    # record (stage breakdown + coalesce context for the headline
    # bootstrap_commit_s number).
    out["flight"] = engine.flight.stats()
    if boot_rec is None:        # late-landing record: last-chance scan
        boot_rec = next(
            (r for r in engine.flight.records()
             if "bench-bootstrap-push" in r.trace_ids), None)
    out["bootstrap_record"] = boot_rec.to_json() if boot_rec else None
    return out


def main(argv) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m crdt_graph_tpu_torch.bench.serving",
        description="The serving engine under mixed in-process traffic.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("docs", nargs="?", type=int, default=4)
    ap.add_argument("seconds", nargs="?", type=float, default=5.0)
    opts = ap.parse_args(argv)
    print(json.dumps(run(n_docs=opts.docs, seconds=opts.seconds,
                         device=opts.device)), flush=True)


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
