"""Disaggregated merge tier headline (docs/MERGETIER.md): what pooling
merge compute buys — cross-FRONT-END batch coalescing — same host,
interleaved legs; the port's counterpart of
``scripts/bench_mergetier_headline.py``, every worker and front-end
merging on the card unless ``device`` names another.

Three front-end serving engines run the SAME closed-loop, oracle-checked
load (``bench/loadgen.py``: one session per document, kernel-sized
deltas that clear the remote route), three ways, alternating per round:

- ``coalesced`` — all three front-ends share ONE merge worker: every
  scheduler round's candidate sets from the whole fleet accumulate in
  the worker's linger window and launch as one ``batched_materialize``;
- ``perreplica`` — the same tier topology but one PRIVATE worker per
  front-end: batching can only happen within a single replica's round
  (compute moved, nothing pooled);
- ``local`` — tier off entirely: the untouched in-process merge path,
  for the ack-latency context number.

The headline is the doc-weighted mean launch width (each remote-merged
document reports the width of the launch its frame rode in).  Gate:
coalesced mean width ≥ 2× the per-replica baseline's, zero fallbacks on
both tiered legs, zero oracle violations on EVERY leg.

Writes ``build/headline/BENCH_MERGETIER.json`` (or ``out_path``).  Run:
``python -m crdt_graph_tpu_torch.scripts.bench_mergetier_headline
[out_path] [--device cpu]``.
"""
from __future__ import annotations

import os
import sys
import threading
import time

from . import _headline
from ..bench import loadgen
from ..mergetier import MergeTierClient, MergeWorker
from ..obs import flight as flight_mod
from ..serve import ServingEngine

N_FRONTENDS = 3
LEGS = ("coalesced", "perreplica", "local")
# one session per doc, deltas over the remote-route floor: every write
# is a remote-eligible round, so achieved width measures COALESCING,
# not routing luck
N_DOCS = 4
# sessions a document (the reference's shape has one: its staged first
# round then waits out the load generator's 30 s staging deadline, as
# no document ever queues two writes)
SESSIONS_PER_DOC = 1
WRITES_PER_SESSION = 3
DELTA_SIZE = 1100
MIN_OPS = 1024
LINGER_MS = 150.0      # wide enough that three front-ends' concurrent
#                        rounds reliably meet in one worker window
MAX_WIDTH = 16


def _cfg(seed: int, dev) -> loadgen.LoadgenConfig:
    return loadgen.LoadgenConfig(
        n_sessions=N_DOCS * SESSIONS_PER_DOC, n_docs=N_DOCS,
        writes_per_session=WRITES_PER_SESSION,
        delta_size=DELTA_SIZE, backspace_p=0.0,
        stage_first_round=True, giant_ops=0, seed=seed, device=dev)


def _leg(leg: str, round_no: int, dev) -> dict:
    """One leg: N_FRONTENDS concurrent loadgen runs, each against its
    own serving engine; the tier topology is the only variable."""
    workers = []
    if leg == "coalesced":
        workers = [MergeWorker(linger_ms=LINGER_MS, max_width=MAX_WIDTH,
                               name="pool-w0", device=dev)]
        tiers = [MergeTierClient([workers[0]], src=f"fe{i}")
                 for i in range(N_FRONTENDS)]
    elif leg == "perreplica":
        workers = [MergeWorker(linger_ms=LINGER_MS, max_width=MAX_WIDTH,
                               name=f"own-w{i}", device=dev)
                   for i in range(N_FRONTENDS)]
        tiers = [MergeTierClient([workers[i]], src=f"fe{i}")
                 for i in range(N_FRONTENDS)]
    else:
        tiers = [None] * N_FRONTENDS
    engines = [ServingEngine(
        flight=flight_mod.FlightRecorder(capacity=4096),
        mergetier=tiers[i], device=dev) for i in range(N_FRONTENDS)]
    reports: list = [None] * N_FRONTENDS
    t0 = time.monotonic()
    try:
        def drive(i: int) -> None:
            reports[i] = loadgen.run(
                _cfg(seed=1000 * round_no + 17 * i + 1, dev=dev),
                engine=engines[i])

        ths = [threading.Thread(target=drive, args=(i,), daemon=True)
               for i in range(N_FRONTENDS)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(600)
        wall = time.monotonic() - t0
    finally:
        for e in engines:
            e.close()
        for w in workers:
            w.close()
    assert all(r is not None for r in reports), "a front-end never finished"
    violations = [v for r in reports for v in r["violations"]]
    errors = [e for r in reports for e in r["errors"]]
    acked = sum(r["writes_acked"] for r in reports)
    out = {
        "leg": leg, "frontends": N_FRONTENDS, "wall_s": round(wall, 3),
        "writes_acked": acked,
        "writes_per_sec": round(acked / wall, 1),
        "violations": violations, "errors": errors,
        "ack_breakdown_ms": [r["ack_breakdown_ms"] for r in reports],
    }
    if leg != "local":
        msts = [r["mergetier"] for r in reports]
        assert all(m is not None for m in msts)
        width_sum = sum(m["width"]["sum"] for m in msts)
        width_count = sum(m["width"]["count"] for m in msts)
        out.update({
            "remote_docs": sum(m["remote_docs"] for m in msts),
            "remote_ops": sum(m["remote_ops"] for m in msts),
            "fallbacks": {k: v for m in msts
                          for k, v in m["fallbacks"].items()},
            "mean_width": round(width_sum / max(width_count, 1), 3),
            "max_width": max((m["width"]["max"] or 0) for m in msts),
            "worker_launches": sum(
                w.stats()["batcher"]["launches"] for w in workers),
            "worker_batch_width": [w.stats()["batch_width"]
                                   for w in workers],
        })
    else:
        assert all(r["mergetier"] is None for r in reports)
    return out


def run(rounds: int = 2, out_path: str = None, device=None) -> dict:
    dev = _headline.resolve(device)
    audit0 = _headline.audit_mark()
    t0 = time.time()
    saved = os.environ.get("GRAFT_MERGETIER_MIN_OPS")
    os.environ["GRAFT_MERGETIER_MIN_OPS"] = str(MIN_OPS)
    per_round = {leg: [] for leg in LEGS}
    try:
        for r in range(rounds):
            for leg in LEGS:    # interleaved: same host, same shape
                rep = _leg(leg, r, dev)
                per_round[leg].append(rep)
                width = (f", mean width {rep['mean_width']} "
                         f"(max {rep['max_width']}, "
                         f"{rep['worker_launches']} launches)"
                         if leg != "local" else "")
                print(f"round {r} {leg}: {rep['writes_acked']} acked "
                      f"in {rep['wall_s']}s{width}", flush=True)
    finally:
        if saved is None:
            os.environ.pop("GRAFT_MERGETIER_MIN_OPS", None)
        else:
            os.environ["GRAFT_MERGETIER_MIN_OPS"] = saved
    best = {}
    for leg in LEGS:
        key = (lambda x: x.get("mean_width", 0.0)) \
            if leg != "local" else (lambda x: x["writes_per_sec"])
        best[leg] = max(per_round[leg], key=key)
    ratio = round(best["coalesced"]["mean_width"]
                  / max(best["perreplica"]["mean_width"], 1e-9), 3)
    violations = [v for leg in LEGS for x in per_round[leg]
                  for v in x["violations"]]
    errors = [e for leg in LEGS for x in per_round[leg]
              for e in x["errors"]]
    fallbacks = {k: v for leg in ("coalesced", "perreplica")
                 for x in per_round[leg]
                 for k, v in x.get("fallbacks", {}).items()}
    block = _headline.device_block(dev)
    out = {
        "bench": "mergetier", "round": 1,
        "backend": _headline.platform_tag(block),
        "device": block,
        "flight_audit": _headline.audit_since(audit0),
        "config": {"frontends": N_FRONTENDS, "n_docs": N_DOCS,
                   "writes_per_session": WRITES_PER_SESSION,
                   "delta_size": DELTA_SIZE, "min_ops": MIN_OPS,
                   "linger_ms": LINGER_MS, "max_width": MAX_WIDTH,
                   "rounds": rounds, "interleaved": True},
        "legs": {leg: {"best": best[leg],
                       "all_rounds": [
                           {k: x.get(k) for k in
                            ("wall_s", "writes_acked", "writes_per_sec",
                             "mean_width", "max_width",
                             "worker_launches", "remote_docs")}
                           for x in per_round[leg]]}
                 for leg in LEGS},
        "mean_width_ratio": ratio,
        "gate": {"want": "coalesced mean width >= 2x per-replica "
                         "baseline, zero fallbacks on tiered legs, "
                         "0 violations every leg",
                 "pass": ratio >= 2.0 and not fallbacks
                         and not violations},
        "violations_total": len(violations),
        "errors_total": len(errors),
        "wall_s": round(time.time() - t0, 1),
    }
    # the output is written before the gates are asserted, so a failed
    # gate's measured ratio is on record beside its threshold
    out_path = out_path or _headline.out_path("mergetier")
    _headline.write(out, out_path)
    assert not errors, errors[:5]
    assert not violations, violations[:5]
    assert not fallbacks, fallbacks
    _headline.speed_gate(out, ratio)
    print(f"PASS: coalesced mean width "
          f"{best['coalesced']['mean_width']} vs per-replica "
          f"{best['perreplica']['mean_width']} (ratio {ratio}), "
          f"local {best['local']['writes_per_sec']} writes/s "
          f"-> {out_path}", flush=True)
    return out


def main(argv=None) -> int:
    device, argv = _headline.split_device(
        list(sys.argv[1:] if argv is None else argv))
    run(out_path=argv[0] if argv else None, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
