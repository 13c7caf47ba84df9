"""Fleet-headline bench: the multi-server artifact, the port's
counterpart of ``scripts/bench_fleet_headline.py``, every server's
merges on the card unless ``device`` names another.

Drives a 3-server in-process replica fleet (``cluster/gateway.py``)
with concurrent closed-loop sessions through ``loadgen.run_fleet``:
writes enter through every server and forward to each document's ring
primary, reads spray across replicas (replica-local, never proxied), a
giant chunk-spanning delta races a mid-merge **server kill** (lease NOT
released — failover happens by TTL expiry, the victim rejoins under its
old name with a bumped fencing epoch), and anti-entropy pulls bounded
``operationsSince`` windows the whole time.  The online
session-guarantee oracle checks read-your-writes (through the
committing node), per-replica-incarnation monotonic reads, dropped
acks, and — at quiescence — cross-replica convergence over the
replica-independent ``X-State-Fingerprint``; a single violation fails
the run.

Writes ``build/headline/BENCH_FLEET.json``: sessions, sustained acked
ops/sec, anti-entropy lag p50/p99 (client-observed
ack→visible-on-another-replica), reader p99 on non-primary replicas,
kill/failover outcome, oracle checks/violations, the card's name and
power limit, and the commits the flight recorders sampled.

Run: ``python -m crdt_graph_tpu_torch.scripts.bench_fleet_headline
[sessions] [writes] [out_path] [--device cpu]``.  Exits non-zero on any
oracle violation or session error.
"""
import json
import sys
import time

from . import _headline


def run(n_sessions: int = 60, writes_per_session: int = 10,
        out_path: str = None, delta_size: int = 12, n_docs: int = 6,
        n_servers: int = 3, giant_ops: int = 40_000,
        delta_cap: int = 8192, seed: int = 1, device=None) -> dict:
    from ..bench import loadgen

    dev = _headline.resolve(device)
    cfg = loadgen.LoadgenConfig(
        n_sessions=n_sessions, n_docs=n_docs,
        writes_per_session=writes_per_session, delta_size=delta_size,
        giant_ops=giant_ops, seed=seed,
        # fleet shape: 3 servers, a sub-giant delta cap so the giant's
        # replication is a chain of RESUMABLE windows, kill + rejoin
        n_servers=n_servers, delta_cap=delta_cap,
        lease_ttl_s=3.0, ae_interval_s=0.1,
        kill_mid_run=True, restart_killed=True,
        stage_first_round=False, device=dev)
    audit0 = _headline.audit_mark()
    t0 = time.time()
    rep = loadgen.run_fleet(cfg)
    oracle = rep["oracle"]
    block = _headline.device_block(dev)
    out = {
        "bench": "fleet_headline",
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
        "antientropy_lag_p50_s": rep["lag_p50_s"],
        "antientropy_lag_p99_s": rep["lag_p99_s"],
        "read_replica_p99_ms": rep["read_replica_p99_ms"],
        "read_primary_p99_ms": rep["read_primary_p99_ms"],
        "kill": rep["kill"],
        "oracle_checks": sum(oracle["checks"].values()),
        "violations_total": oracle["violations_total"],
        "converged_docs": len(rep["converged"]),
        # -- the full report ---------------------------------------------
        "report": rep,
    }
    _headline.write(out, out_path or _headline.out_path("fleet"))
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
    print("bench_fleet_headline OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
