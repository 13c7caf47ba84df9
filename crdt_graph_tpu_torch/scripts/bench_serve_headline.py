"""Serving-headline bench: the full closed-loop oracle-checked run, the
port's counterpart of ``scripts/bench_serve_headline.py``, on the card
unless ``device`` names another.

Drives the real HTTP surface with hundreds of concurrent sessions
(editor-replay + burst + shed-and-read + one giant chunked-merge racer,
``crdt_graph_tpu_torch/bench/loadgen.py``) while the online
session-guarantee oracle (``crdt_graph_tpu_torch/obs/oracle.py``)
checks read-your-writes, monotonic reads, dropped acks, and convergence
from the trace/flight stream.  Writes the serving-headline artifact
(``build/headline/BENCH_SERVE.json``): sustained merged ops/sec, reader
p50/p99 under load, violation count (must be 0), the card's name and
power limit, and the commits the flight recorder sampled.

Run: ``python -m crdt_graph_tpu_torch.scripts.bench_serve_headline
[sessions] [writes] [out_path] [--device cpu]`` — defaults 200 sessions
x 24 writes x 12 leaves (+ a 140k-op giant racer) ≈ 200k total leaves.
Exits non-zero on any oracle violation or session error.
"""
import json
import sys
import time

from . import _headline


def run(n_sessions: int = 200, writes_per_session: int = 24,
        out_path: str = None, delta_size: int = 12, n_docs: int = 8,
        giant_ops: int = 140_000, seed: int = 1, device=None) -> dict:
    from ..bench import loadgen

    dev = _headline.resolve(device)
    cfg = loadgen.LoadgenConfig(
        n_sessions=n_sessions, n_docs=n_docs,
        writes_per_session=writes_per_session, delta_size=delta_size,
        max_queue_requests=16,   # < sessions-per-doc: the staged first
                                 # round guarantees 429 shedding
        giant_ops=giant_ops, stage_first_round=True, seed=seed,
        device=dev)
    audit0 = _headline.audit_mark()
    t0 = time.time()
    rep = loadgen.run(cfg)
    block = _headline.device_block(dev)
    out = {
        "bench": "serve_headline",
        "rev": "r01",
        "host": _headline.platform_tag(block),
        "at": round(t0, 1),
        "device": block,
        "flight_audit": _headline.audit_since(audit0),
        # -- the headline ------------------------------------------------
        "sessions": rep["sessions"],
        "total_leaves": rep["leaves_acked"],
        "ops_merged": rep["ops_merged"],
        "sustained_ops_per_sec": rep["ops_per_sec"],
        "read_p50_ms": rep["read_p50_ms"],
        "read_p99_ms": rep["read_p99_ms"],
        "violations_total": rep["oracle"]["violations_total"],
        # -- the full report ---------------------------------------------
        "report": rep,
    }
    _headline.write(out, out_path or _headline.out_path("serve"))
    return out


def main(argv=None) -> int:
    device, argv = _headline.split_device(
        list(sys.argv[1:] if argv is None else argv))
    kw = {"device": device}
    if argv:
        kw["n_sessions"] = int(argv[0])
    if len(argv) > 1:
        kw["writes_per_session"] = int(argv[1])
    if len(argv) > 2:
        kw["out_path"] = argv[2]
    out = run(**kw)
    print(json.dumps({k: v for k, v in out.items() if k != "report"},
                     indent=1), flush=True)
    rep = out["report"]
    if out["violations_total"] or rep["errors"]:
        print(f"FAIL: violations={out['violations_total']} "
              f"errors={rep['errors'][:3]}", file=sys.stderr)
        return 1
    print("bench_serve_headline OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
