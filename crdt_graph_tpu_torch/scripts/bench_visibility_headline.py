"""Visibility-headline bench: the write-to-visibility ledger + canary
artifact (docs/OBSERVABILITY.md §Fleet tracing & visibility ledger), the
port's counterpart of ``scripts/bench_visibility_headline.py``, every
server's merges on the card unless ``device`` names another.

Drives the same 3-server in-process replica fleet as the fleet
headline (``loadgen.run_fleet``: forwarded writes, replica-spread
reads, a windowed giant, anti-entropy pulling the whole time, the
online session-guarantee oracle checking every read) — but with the
canary probers ticking at a sub-second interval so the continuous
synthetic-writer path is measured IN the run, not idealized beside
it.  The artifact's headline is the per-stage visibility-lag
distribution the ledger accumulated from the real traffic
(``publish`` = ack→watchable at the writer, ``replica`` = one-way
skew-BOUND from the committing node's send stamp to the puller's
apply), aggregated across nodes by bucket-merge — never by averaging
percentiles — plus the canary's own end-to-end numbers.

Gates (exit non-zero / ``gate.pass`` false):

- zero oracle violations and zero session errors (the load is still
  correctness-checked — lag numbers from a wrong fleet are noise);
- ``publish`` and ``replica`` stage histograms both non-empty with
  derived p50/p99 (the ledger actually observed the run);
- canary probes fired on the live nodes AND canary write overhead
  stayed under 1% of acked throughput — continuous probing must be
  affordable, or nobody will leave it default-on.

Writes ``build/headline/BENCH_VISIBILITY.json``.  Run:
``python -m crdt_graph_tpu_torch.scripts.bench_visibility_headline
[sessions] [writes] [out_path] [--device cpu]``.
"""
import json
import os
import sys
import time

from . import _headline


def _stage_summary(visibility: dict) -> dict:
    """Bucket-merge every node's per-(stage, peer) ledger histograms
    into one summary per stage (shared LAG_BOUNDS_S, so the merge is
    exact)."""
    from ..serve.watch import merge_notify_hists
    by_stage: dict = {}
    for _node, vrep in visibility.items():
        led = (vrep or {}).get("ledger")
        if not led:
            continue
        for row in led["lag"]:
            by_stage.setdefault(row["stage"], []).append(row["hist"])
    return {stage: merge_notify_hists(hists)
            for stage, hists in sorted(by_stage.items())}


def _canary_summary(visibility: dict) -> dict:
    from ..serve.watch import merge_notify_hists
    e2e, probes, failures, breaches = [], 0, 0, 0
    stage_hists: dict = {}
    for _node, vrep in visibility.items():
        can = (vrep or {}).get("canary")
        if not can:
            continue
        probes += can["probes"]
        failures += sum(can["failures"].values())
        breaches += can["slo_breaches"]
        e2e.append(can["e2e"])
        for stage, h in can["stages"].items():
            stage_hists.setdefault(stage, []).append(h)
    return {"probes": probes, "failures": failures,
            "slo_breaches": breaches,
            "e2e": merge_notify_hists(e2e),
            "stages": {s: merge_notify_hists(hs)
                       for s, hs in sorted(stage_hists.items())}}


def run(n_sessions: int = 36, writes_per_session: int = 8,
        out_path: str = None, delta_size: int = 12, n_docs: int = 6,
        n_servers: int = 3, giant_ops: int = 20_000,
        delta_cap: int = 8192, canary_interval_s: float = 0.5,
        seed: int = 4, device=None) -> dict:
    from ..bench import loadgen

    dev = _headline.resolve(device)
    cfg = loadgen.LoadgenConfig(
        n_sessions=n_sessions, n_docs=n_docs,
        writes_per_session=writes_per_session, delta_size=delta_size,
        giant_ops=giant_ops, seed=seed,
        n_servers=n_servers, delta_cap=delta_cap,
        lease_ttl_s=3.0, ae_interval_s=0.1,
        kill_mid_run=False, stage_first_round=False, device=dev)
    # sub-second canary ticks for the duration of the run only — the
    # probers arm when the fleet spawns inside run_fleet
    prev = os.environ.get("GRAFT_CANARY_INTERVAL_S")
    os.environ["GRAFT_CANARY_INTERVAL_S"] = str(canary_interval_s)
    audit0 = _headline.audit_mark()
    t0 = time.time()
    try:
        rep = loadgen.run_fleet(cfg)
    finally:
        if prev is None:
            os.environ.pop("GRAFT_CANARY_INTERVAL_S", None)
        else:
            os.environ["GRAFT_CANARY_INTERVAL_S"] = prev
    oracle = rep["oracle"]
    stages = _stage_summary(rep["visibility"])
    canary = _canary_summary(rep["visibility"])
    # canary overhead: each probe is one single-leaf write through the
    # real admission path — compare against the load's acked leaves
    overhead_pct = (100.0 * canary["probes"] / rep["leaves_acked"]
                    if rep["leaves_acked"] else None)
    gate = {
        "zero_violations": oracle["violations_total"] == 0
        and not rep["errors"],
        "stage_lag_present": all(
            stages.get(s, {}).get("count", 0) > 0
            and stages[s]["p50"] is not None
            and stages[s]["p99"] is not None
            for s in ("publish", "replica")),
        "canary_probed": canary["probes"] >= 1,
        "canary_overhead_under_1pct": overhead_pct is not None
        and overhead_pct < 1.0,
    }
    gate["pass"] = all(gate.values())
    block = _headline.device_block(dev)
    out = {
        "bench": "visibility_headline",
        "rev": "r01",
        "host": _headline.platform_tag(block),
        "at": round(t0, 1),
        "device": block,
        "flight_audit": _headline.audit_since(audit0),
        # -- the headline ------------------------------------------------
        "servers": rep["servers"],
        "sessions": rep["sessions"],
        "total_leaves": rep["leaves_acked"],
        "sustained_ops_per_sec": rep["ops_per_sec"],
        "visibility_lag_s": {
            s: {"count": v["count"], "p50": v["p50"], "p99": v["p99"],
                "max": v["max"]} for s, v in stages.items()},
        "canary": {"probes": canary["probes"],
                   "failures": canary["failures"],
                   "slo_breaches": canary["slo_breaches"],
                   "e2e_p50_s": canary["e2e"]["p50"],
                   "e2e_p99_s": canary["e2e"]["p99"],
                   "overhead_pct_of_acked": round(overhead_pct, 4)
                   if overhead_pct is not None else None},
        "oracle_checks": sum(oracle["checks"].values()),
        "violations_total": oracle["violations_total"],
        "gate": gate,
        # -- the full distributions --------------------------------------
        "stages_full": stages,
        "canary_full": canary,
        "report": rep,
    }
    _headline.write(out, out_path or _headline.out_path("visibility"))
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
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("report", "stages_full",
                                   "canary_full")}, indent=1),
          flush=True)
    if not out["gate"]["pass"]:
        print(f"FAIL: gate={out['gate']}", file=sys.stderr)
        return 1
    print("bench_visibility_headline OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
