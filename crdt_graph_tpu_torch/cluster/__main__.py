"""Run one fleet node as a process:

``python -m crdt_graph_tpu_torch.cluster --name n0 --kv-dir /tmp/fleet
--port 8931 [--ttl 5.0] [--ae-interval 0.25] [--delta-cap 65536]``

The node's serving engine merges on the card; ``--cpu`` runs its merges
on the host CPU through the kernels' plain twins instead (without a
card and without ``--cpu`` it raises).  All nodes pointed at the same
``--kv-dir`` (a shared FileKV spool — one host) discover each other
through the lease table and converge through anti-entropy; no argument
lists the peers.  Prints one ``READY {json}`` line to stdout once
serving, then serves until SIGTERM/SIGINT (graceful: lease released) or
a hard kill (crash path: peers fail it over on lease expiry).
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m crdt_graph_tpu_torch.cluster")
    ap.add_argument("--name", required=True,
                    help="stable node name (restart reclaims the "
                         "same lease slot)")
    ap.add_argument("--kv-dir", required=True,
                    help="shared FileKV spool directory")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--ttl", type=float, default=5.0)
    ap.add_argument("--ae-interval", type=float, default=0.25)
    ap.add_argument("--delta-cap", type=int, default=65_536)
    ap.add_argument("--durable-dir", default=None,
                    help="crash-durable acked writes: per-doc tier "
                         "manifests + a group-commit WAL under this "
                         "dir; a restart recovers to serving with "
                         "zero acked-write loss (docs/DURABILITY.md)")
    ap.add_argument("--wal-sync", default="batch",
                    choices=("commit", "batch", "off"),
                    help="WAL fsync policy (only with --durable-dir)")
    ap.add_argument("--wal-shared", action="store_true",
                    help="multiplex every document's WAL records into "
                         "ONE per-node stream: one fsync per scheduler "
                         "round covers all documents (GRAFT_WAL_SHARED; "
                         "docs/DURABILITY.md §Shared WAL) — the "
                         "many-small-docs fleet shape")
    ap.add_argument("--netchaos", default=None,
                    help="deterministic network fault plan "
                         "('<seed>:<spec>', cluster/netchaos.py "
                         "grammar) for this node's OUTBOUND fleet "
                         "links; equivalent to GRAFT_NETCHAOS")
    ap.add_argument("--max-staleness", type=float, default=None,
                    help="server-wide bounded-staleness read default "
                         "in seconds (GRAFT_MAX_STALENESS_S): reads "
                         "on a replica whose anti-entropy lag exceeds "
                         "it answer 503 + Retry-After")
    ap.add_argument("--scrub-interval", type=float, default=None,
                    help="cold-file checksum scrub cadence in seconds "
                         "(GRAFT_SCRUB_INTERVAL_S; 0 = off): corrupt "
                         "segments quarantine and heal from fleet "
                         "peers (docs/DURABILITY.md §Scrub & repair)")
    ap.add_argument("--cpu", action="store_true",
                    help="merge on the host CPU (the kernels' plain "
                         "twins) instead of the card")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    import os

    if args.scrub_interval is not None:
        os.environ["GRAFT_SCRUB_INTERVAL_S"] = str(args.scrub_interval)

    from . import FileKV, FleetServer, NetChaos

    chaos = None
    if args.netchaos:
        chaos = NetChaos.parse(args.netchaos)

    engine = None
    if args.durable_dir:
        from ..obs import flight as flight_mod
        from ..serve import ServingEngine
        engine = ServingEngine(durable_dir=args.durable_dir,
                               wal_sync=args.wal_sync,
                               wal_shared=args.wal_shared,
                               flight=flight_mod.FlightRecorder(),
                               device=device)
    node_kw = {}
    if args.max_staleness is not None:
        node_kw["max_staleness_s"] = args.max_staleness
    fs = FleetServer(args.name, FileKV(args.kv_dir), port=args.port,
                     engine=engine, netchaos=chaos, device=device,
                     ttl_s=args.ttl, ae_interval_s=args.ae_interval,
                     delta_cap=args.delta_cap, **node_kw)
    # the handlers go in before READY: a supervisor may signal the
    # moment it reads the line
    done = threading.Event()

    def _term(signum, frame):
        done.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    print("READY " + json.dumps(
        {"name": fs.name, "addr": fs.addr,
         "id": fs.node.node_id(), "epoch": fs.node.epoch(),
         "durable": bool(args.durable_dir),
         "recovered_docs": sorted(
             d.doc_id for d in fs.node.engine.docs() if d.recovered)}),
        flush=True)

    done.wait()
    fs.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
