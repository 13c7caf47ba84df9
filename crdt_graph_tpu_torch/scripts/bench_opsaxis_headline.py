"""Ops-axis headline: an interleaved A/B of the ops-axis sharded merge
against the single-device merge at the config-5 shape — the port's
counterpart of ``scripts/bench_opsaxis_headline.py``, on the card
unless ``device`` names another.

Two legs on the SAME padded arrays, interleaved per round (never
sequential blocks — drift lands on both legs):

- ``sharded``: ``parallel/opsaxis.materialize`` — the merge in k
  shards with halo-windowed plane sweeps and the ring carry exchange
  (kernel 5, ``csrc/ring_carry.cu``).  On one card the shards are
  ``k = 8`` logical shards on it (the reference's mesh width); with two
  or more cards they lie one a card, as ``materialize(k=None)`` puts
  them.
- ``single``: ``merge.materialize`` — the single-device merge.

Timing per repeat: dispatch + the readback of ``bench.honest.
fingerprint`` (a scalar depending on every table field, bit-equal to
the reference's); the two legs' fingerprints are asserted EQUAL first
(bit-identity is the contract the wall-clock rides on).  Then one
audited sharded merge (``opsaxis.audit_opsaxis``, outside the timed
repeats) attaches the per-shard width (≤ ceil(M/k) + halo) and the
carry exchange's bytes.  A sharded leg slower than
``TRIPWIRE_MAX_SLOWDOWN`` times the single leg is a broken path (a
pathological fallback or a widened shard): the tripwire the reference
keeps.

Writes ``build/headline/BENCH_OPSAXIS.json``.  Run: ``python -m
crdt_graph_tpu_torch.scripts.bench_opsaxis_headline [n_ops] [repeats]
[out] [--device cpu]``.
"""
import json
import os
import sys
import time

import numpy as np

from . import _headline
from ..bench import honest, workloads
from ..codec import packed
from ..ops import merge
from ..parallel import opsaxis

# a sharded leg slower than this multiple of the single-device leg is a
# broken path (hang / wholesale fallback / widened shard), not sharding
# overhead — the reference's tripwire
TRIPWIRE_MAX_SLOWDOWN = 25.0
# logical shards on one card: the reference's 8-device mesh width
LOGICAL_SHARDS = 8


def _fingerprint_host(table) -> int:
    return int(honest.fingerprint(table))


def run(n_ops: int = 1_000_000, repeats: int = 3,
        out_path: str = None, device=None) -> dict:
    dev = _headline.resolve(device)
    cards = opsaxis.mesh_devices() if dev.type == "cuda" else 1
    # one shard a card across two or more cards (materialize(k=None));
    # 8 logical shards on one card or on the CPU
    k = cards if cards >= 2 else LOGICAL_SHARDS
    k_arg = None if cards >= 2 else k
    arrs = workloads.chain_workload(64, n_ops)
    n = arrs["kind"].shape[0]
    n_pad = -(-n // k) * k
    padded = packed.pad_arrays(arrs, n_pad) if n_pad != n else arrs

    legs = {
        "sharded": lambda: opsaxis.materialize(
            padded, k=k_arg, hints="exhaustive", device=dev),
        "single": lambda: merge.materialize(padded, hints="exhaustive",
                                            device=dev),
    }
    # warm + bit-identity gate before any timing
    print("# warming + bit-identity check", file=sys.stderr)
    fps = {}
    for name, fn in legs.items():
        tab = fn()
        fps[name] = _fingerprint_host(tab)
    assert fps["sharded"] == fps["single"], \
        f"bit-identity violated: {fps}"

    times = {name: [] for name in legs}
    for r in range(repeats):
        for name, fn in legs.items():        # interleaved, not blocks
            t0 = time.perf_counter()
            tab = fn()
            fp = _fingerprint_host(tab)
            dt = (time.perf_counter() - t0) * 1e3
            assert fp == fps[name]
            times[name].append(round(dt, 3))
            print(f"# round {r} {name}: {dt:.3f} ms", file=sys.stderr)

    p50 = {name: float(np.percentile(ts, 50))
           for name, ts in times.items()}
    audit = opsaxis.audit_opsaxis(arrs, k=k_arg, device=dev)
    speedup = p50["single"] / p50["sharded"]
    block = _headline.device_block(dev)
    out = {
        "bench": "opsaxis_headline_ab",
        "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                     time.gmtime()),
        "config": "join_64rep_1M" if n_ops == 1_000_000
        else f"join_64rep_{n_ops}",
        "n_ops": int(n_pad),
        "devices": k,
        "host_cores": os.cpu_count(),
        "platform": _headline.platform_tag(block),
        "device": block,
        "interleaved": True,
        "repeats": repeats,
        "times_ms": times,
        "p50_ms": {name: round(v, 3) for name, v in p50.items()},
        "sharded_vs_single_speedup": round(speedup, 3),
        "bit_identical": True,
        "fingerprint": fps["single"],
        # the audited shard width and carry exchange of one sharded
        # merge, run after the timed repeats
        "opsaxis_audit": audit,
        "tripwire": {
            "max_slowdown": TRIPWIRE_MAX_SLOWDOWN,
            "ok": bool(speedup >= 1.0 / TRIPWIRE_MAX_SLOWDOWN),
        },
        "note": (f"{k} shards: one a card across {cards} cards"
                 if cards >= 2 else
                 f"{k} logical shards on one device: the wall-clock A/B "
                 f"prices the sharding's extra dispatches and the carry "
                 f"exchange, not a speedup across devices"),
    }
    _headline.write(out, out_path or _headline.out_path("opsaxis"))
    print(json.dumps(out["p50_ms"] | {
        "speedup": out["sharded_vs_single_speedup"],
        "shard_width": audit["shard_width"],
        "collective_bytes": audit["collective_bytes"]}))
    return out


def main(argv=None) -> int:
    device, argv = _headline.split_device(
        list(sys.argv[1:] if argv is None else argv))
    n = int(argv[0]) if len(argv) > 0 else 1_000_000
    r = int(argv[1]) if len(argv) > 1 else 3
    out = argv[2] if len(argv) > 2 else None
    run(n, r, out, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
