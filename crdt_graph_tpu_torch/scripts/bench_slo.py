"""Interactive-scale serving SLO: p50/p99 latency of ``POST
/docs/{id}/ops`` for the three editor-shaped delta sizes — 1 op
(keystroke), 64 ops (sync burst), 4096 ops (reconnect catch-up) —
through the real HTTP service and the ServingEngine scheduler; the
port's counterpart of ``scripts/bench_slo.py``, its server merging on
the card unless ``device`` names another.

The sizes bracket the engine's routing thresholds (``engine.apply``):
1 and 64 ≤ DELTA_THRESHOLD=256 ride the O(delta) host mirror; 4096
crosses ``packed_route`` (n ≥ max(1024, log/8)) and dispatches the
merge on the device — the crossover whose two sides the SLO table
documents.

Prints one JSON line per size, as the reference does, and writes them
with the card's tag to ``build/headline/BENCH_SLO.json`` (or
``out_path``).  Run: ``python -m crdt_graph_tpu_torch.scripts.bench_slo
[bootstrap_ops] [reps] [--device cpu]`` (defaults 8192 60).
"""
import json
import sys
import threading
import time
from http.client import HTTPConnection

from . import _headline
from ..codec import json_codec
from ..core.operation import Add, Batch
from ..service import make_server

OFFSET = 2**32


def _delta(replica: int, counter: int, anchor: int, size: int):
    ops = []
    prev = anchor
    for _ in range(size):
        counter += 1
        ts = replica * OFFSET + counter
        ops.append(Add(ts, (prev,), counter % 997))
        prev = ts
    return Batch(tuple(ops)), counter, prev


def run(bootstrap: int = 8192, reps: int = 60, out_path: str = None,
        device=None) -> dict:
    dev = _headline.resolve(device)
    audit0 = _headline.audit_mark()
    srv = make_server(port=0, device=dev)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_port

    def post(doc, body):
        conn = HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("POST", f"/docs/{doc}/ops", body=body)
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, data

    rows = []
    try:
        for size in (1, 64, 4096):
            doc = f"slo{size}"
            counter, anchor = 0, 0
            boot, counter, anchor = _delta(7, counter, anchor, bootstrap)
            st, out = post(doc, json_codec.dumps(boot))
            assert st == 200 and json.loads(out)["accepted"], out[:200]
            n = reps if size < 4096 else max(reps // 3, 10)
            # pre-encode all bodies: the SLO times the service, not the
            # bench's own op-object churn
            bodies = []
            for _ in range(n + 3):
                d, counter, anchor = _delta(7, counter, anchor, size)
                bodies.append(json_codec.dumps(d))
            lats = []
            for i, body in enumerate(bodies):
                t0 = time.perf_counter()
                st, out = post(doc, body)
                dt = (time.perf_counter() - t0) * 1e3
                assert st == 200 and json.loads(out)["accepted"], out[:200]
                if i >= 3:                      # warmup requests excluded
                    lats.append(dt)
            lats.sort()
            rows.append({
                "delta_ops": size,
                "requests": len(lats),
                "p50_ms": round(lats[len(lats) // 2], 2),
                "p99_ms": round(lats[min(len(lats) - 1,
                                         int(len(lats) * 0.99))], 2),
                "max_ms": round(lats[-1], 2),
                "route": "host mirror (<= DELTA_THRESHOLD)" if size <= 256
                         else "kernel (packed_route)",
                "bootstrap_ops": bootstrap,
            })
            # every acked op is in the document the server publishes
            visible = len(srv.store.get(doc).snapshot_view().values)
            rows[-1]["visible"] = visible
            assert visible == bootstrap + (n + 3) * size, (doc, visible)
    finally:
        srv.shutdown()
        srv.server_close()
    block = _headline.device_block(dev)
    result = {"bench": "slo", "host": _headline.platform_tag(block),
              "device": block,
              "flight_audit": _headline.audit_since(audit0),
              "rows": rows}
    _headline.write(result, out_path or _headline.out_path("slo"))
    return result


def main(argv=None) -> int:
    device, argv = _headline.split_device(
        list(sys.argv[1:] if argv is None else argv))
    bootstrap = int(argv[0]) if len(argv) > 0 else 8192
    reps = int(argv[1]) if len(argv) > 1 else 60
    for row in run(bootstrap, reps, device=device)["rows"]:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
