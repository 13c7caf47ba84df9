"""End-to-end service benchmark: one client bootstraps a 1M-op document
over real HTTP — POST the full wire batch (native parse + kernel merge),
then GET the full log back (native egress) and GET the binary snapshot;
the port's counterpart of ``scripts/bench_service_e2e.py``, its server
merging on the card unless ``device`` names another.

This is the system number the subsystem benches compose into: HTTP +
fastcodec ingest + merge kernel + fastcodec egress + snapshot encode,
measured wall-clock on the serving path.

Prints one JSON line per leg, as the reference does, and writes them
with the card's tag to ``build/headline/BENCH_SERVICE_E2E.json`` (or
``out_path``).  Run: ``python -m
crdt_graph_tpu_torch.scripts.bench_service_e2e [n] [--device cpu]``.
"""
import json
import sys
import threading
import time
from http.client import HTTPConnection

from . import _headline
from .. import native
from ..bench import workloads
from ..codec import packed
from ..service import make_server


def run(n: int = 1_000_000, out_path: str = None, device=None) -> dict:
    dev = _headline.resolve(device)
    audit0 = _headline.audit_mark()
    srv = make_server(port=0, device=dev)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_port

    arrs = workloads.chain_workload(64, n)
    n = int(arrs["kind"].shape[0])     # whole chains: n rounded down
    p = packed.PackedOps(
        kind=arrs["kind"], ts=arrs["ts"], parent_ts=arrs["parent_ts"],
        anchor_ts=arrs["anchor_ts"], depth=arrs["depth"],
        paths=arrs["paths"], value_ref=arrs["value_ref"],
        pos=arrs["pos"], values=[f"v{i % 997}" for i in range(n)],
        num_ops=n, parent_pos=arrs["parent_pos"],
        anchor_pos=arrs["anchor_pos"], target_pos=arrs["target_pos"],
        ts_rank=arrs["ts_rank"], hints_vouched=True)
    wire = native.encode_pack(p)

    def req(method, path, body=None, read=True):
        conn = HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        data = resp.read() if read else b""
        conn.close()
        return resp.status, data

    legs = []
    try:
        t0 = time.perf_counter()
        st, out = req("POST", "/docs/e2e/ops", wire)
        t1 = time.perf_counter()
        assert st == 200 and json.loads(out)["accepted"], out[:200]
        legs.append({"metric": "service_e2e_1M", "leg": "post_ops",
                     "seconds": round(t1 - t0, 3), "bytes": len(wire),
                     "note": "HTTP + native parse + kernel merge + "
                             "status encode"})

        # warm repeat onto a FRESH document: the steady-state serving
        # cost of the same bootstrap
        t0 = time.perf_counter()
        st, out = req("POST", "/docs/e2e_warm/ops", wire)
        t1 = time.perf_counter()
        assert st == 200 and json.loads(out)["accepted"], out[:200]
        legs.append({"metric": "service_e2e_1M", "leg": "post_ops_warm",
                     "seconds": round(t1 - t0, 3), "bytes": len(wire)})

        t0 = time.perf_counter()
        st, log_bytes = req("GET", "/docs/e2e/ops?since=0")
        t1 = time.perf_counter()
        assert st == 200
        legs.append({"metric": "service_e2e_1M",
                     "leg": "get_ops_bootstrap",
                     "seconds": round(t1 - t0, 3),
                     "bytes": len(log_bytes)})

        t0 = time.perf_counter()
        st, snap = req("GET", "/docs/e2e/snapshot")
        t1 = time.perf_counter()
        assert st == 200
        legs.append({"metric": "service_e2e_1M", "leg": "get_snapshot",
                     "seconds": round(t1 - t0, 3), "bytes": len(snap)})
        # the served log is the posted wire, byte for byte
        wire_identical = log_bytes == wire
    finally:
        srv.shutdown()
        srv.server_close()
    block = _headline.device_block(dev)
    result = {"bench": "service_e2e", "n_ops": n,
              "host": _headline.platform_tag(block), "device": block,
              "flight_audit": _headline.audit_since(audit0),
              "wire_identical": wire_identical, "legs": legs}
    _headline.write(result, out_path or _headline.out_path("service_e2e"))
    return result


def main(argv=None) -> int:
    device, argv = _headline.split_device(
        list(sys.argv[1:] if argv is None else argv))
    out = run(int(argv[0]) if argv else 1_000_000, device=device)
    for leg in out["legs"]:
        print(json.dumps(leg), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
