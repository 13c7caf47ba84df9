"""Per-op serving latency: the incremental-apply benchmark.

The original applies one op in O(depth·log b + siblings)
(Internal/Node.elm:51-104); the engine's host-mirror delta path must match
that asymptotic — per-op latency that does NOT grow with document size.
This harness replays a config-1-style editor session (interleaved
insert/delete, models/text.py) on top of pre-seeded documents of
increasing size and reports per-op latency percentiles for each.  The
seeding bootstrap (one remote batch) and the bulk deltas of
:func:`run_bulk` are merges on the replica's device; each row gives the
host cost of building the ``Add`` objects apart from the apply.

Run: ``python -m crdt_graph_tpu_torch.bench.incremental [--device cpu]
[bulk | sizes...]`` (default: the card).
"""
from __future__ import annotations

import json
import random
import sys
import time
from typing import Dict, List

from ..core.operation import Add, Batch
from ..models.text import TextBuffer


def seed_document(buf: TextBuffer, size: int, rid: int = 1) -> dict:
    """Bulk-load ``size`` characters as one remote batch (kernel path for
    big sizes — exactly how a replica bootstraps from anti-entropy).
    Returns the seconds spent building the ops on the host (``build_s``)
    and applying them (``apply_s``)."""
    t0 = time.perf_counter()
    ops, prev = [], 0
    for i in range(1, size + 1):
        ts = rid * 2**32 + i
        ops.append(Add(ts, (prev,), "x"))
        prev = ts
    batch = Batch(tuple(ops))
    t1 = time.perf_counter()
    buf.apply(batch)
    return {"build_s": t1 - t0, "apply_s": time.perf_counter() - t1}


def editor_replay(buf: TextBuffer, n_ops: int, seed: int = 7) -> List[float]:
    """Interleaved single-char inserts (70%) and deletes (30%) at random
    indices; returns per-op wall times."""
    rng = random.Random(seed)
    times: List[float] = []
    for k in range(n_ops):
        n = len(buf)
        t0 = time.perf_counter()
        if n and rng.random() < 0.3:
            buf.delete(rng.randrange(n))
        else:
            buf.insert(rng.randrange(n + 1), chr(97 + k % 26))
        times.append(time.perf_counter() - t0)
    return times


def percentiles(times: List[float]) -> Dict[str, float]:
    s = sorted(times)
    return {
        "p50_us": s[len(s) // 2] * 1e6,
        "p99_us": s[int(len(s) * 0.99)] * 1e6,
    }


def bulk_deltas(buf: TextBuffer, doc_size: int, delta: int,
                rid: int = 3) -> float:
    """One bulk (> DELTA_THRESHOLD) remote batch of ``delta`` causal
    appends onto a ``doc_size`` document; returns the seconds of the
    apply alone.  A bulk apply that re-materialised the WHOLE log would
    be O(doc); the host-first bulk path makes it O(delta), and a delta
    of an eighth of the log or more merges on the device."""
    base = buf.last_replica_timestamp(rid) & (2**32 - 1)
    ops, prev = [], 0
    for i in range(1, delta + 1):
        ts = rid * 2**32 + base + i
        ops.append(Add(ts, (prev,), "y"))
        prev = ts
    t0 = time.perf_counter()
    buf.apply(Batch(tuple(ops)))
    return time.perf_counter() - t0


def run_bulk(doc_sizes=(10_000, 100_000, 1_000_000),
             deltas=(1_000, 10_000), device=None) -> list:
    """Bulk-apply cost vs document size, on a replica whose merges run
    on ``device`` (default the card; it raises without one)."""
    results = []
    for size in doc_sizes:
        buf = TextBuffer(70, engine="tpu", device=device)
        seed = seed_document(buf, size)
        len(buf)
        for delta in deltas:
            secs = bulk_deltas(buf, size, delta, rid=3 + deltas.index(delta))
            row = {"doc_size": size, "bulk_delta": delta,
                   "apply_ms": secs * 1e3,
                   "us_per_op": secs / delta * 1e6,
                   "seed_build_ms": seed["build_s"] * 1e3,
                   "seed_apply_ms": seed["apply_s"] * 1e3}
            results.append(row)
            print(json.dumps(row), flush=True)
    return results


def run(doc_sizes=(1_000, 10_000, 100_000), n_ops: int = 1_000,
        device=None) -> list:
    """Editor per-op latency on seeded documents of each size, on a
    replica whose merges run on ``device`` (default the card; it raises
    without one)."""
    results = []
    for size in doc_sizes:
        # editor replica id ABOVE the seed's: the clock is per-replica
        # counters (not Lamport), so a LOWER-id editor's
        # inserts legitimately skip-scan past every higher-ts sibling to
        # their right (Internal/Node.elm:93-104) — an O(suffix) semantic
        # cost, not an implementation one.  Realistic collaboration has
        # interleaved ids; benching the higher-id editor isolates the
        # engine's own per-op cost.
        buf = TextBuffer(70, engine="tpu", device=device)
        seed = seed_document(buf, size)
        len(buf)                        # warm the path cache / mirror
        stats = percentiles(editor_replay(buf, n_ops))
        row = {"doc_size": size, "n_ops": n_ops, **stats,
               "seed_build_ms": seed["build_s"] * 1e3,
               "seed_apply_ms": seed["apply_s"] * 1e3}
        results.append(row)
        print(json.dumps(row), flush=True)
    return results


def main(argv) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m crdt_graph_tpu_torch.bench.incremental",
        description="Editor per-op latency vs document size, or (bulk) "
                    "the bulk-apply cost vs document size.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("what", nargs="*",
                    help="'bulk', or document sizes (default 1k 10k 100k)")
    opts = ap.parse_args(argv)
    if opts.what == ["bulk"]:
        run_bulk(device=opts.device)
    else:
        sizes = [int(a) for a in opts.what]
        if sizes:
            run(sizes, device=opts.device)
        else:
            run(device=opts.device)


if __name__ == "__main__":
    main(sys.argv[1:])
