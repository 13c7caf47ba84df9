"""Egress benchmark: full-log bootstrap encode of a 1M-op document — the
port's counterpart of ``scripts/bench_egress.py``.

Measures the bootstrap contract (``operationsSince 0`` serving the whole
log, CRDTree.elm:408-418) through three paths:

- python: per-op recursive ``json_codec.dumps``
- native: ``native.encode_pack`` (the fastcodec egress mirror)
- snapshot: binary packed checkpoint bytes (``checkpoint_packed``)

The encoders run on the host; only the replica that checkpoints is
built on ``device`` (the card by default).  Prints one JSON line per
path, as the reference does, and writes them with the card's tag to
``build/headline/BENCH_EGRESS.json`` (or ``out_path``).  Run: ``python
-m crdt_graph_tpu_torch.scripts.bench_egress [n] [--device cpu]``.
"""
import io
import json
import sys
import time

from . import _headline
from .. import engine, native
from ..codec import json_codec, packed
from ..core.operation import Add, Batch


def run(n: int = 1_000_000, out_path: str = None, device=None) -> dict:
    dev = _headline.resolve(device)
    reps = 64
    ops = []
    for r in range(reps):
        base = (r + 1) * 2 ** 32
        prev = 0
        for i in range(n // reps):
            ts = base + i + 1
            ops.append(Add(ts, (prev,), f"v{i % 997}"))
            prev = ts
    p = packed.pack(ops)

    t0 = time.perf_counter()
    wire_py = json_codec.dumps(Batch(tuple(ops)))
    t1 = time.perf_counter()
    py_s = t1 - t0

    native.encode_pack(p)          # warm (module load)
    t0 = time.perf_counter()
    wire_native = native.encode_pack(p)
    t1 = time.perf_counter()
    native_s = t1 - t0
    assert wire_native.decode() == wire_py, "egress differential FAILED"

    rows = [
        {"metric": "egress_bootstrap_1M", "path": "python_json",
         "seconds": round(py_s, 3), "bytes": len(wire_py)},
        {"metric": "egress_bootstrap_1M", "path": "native_encode_pack",
         "seconds": round(native_s, 3), "bytes": len(wire_native),
         "speedup_vs_python": round(py_s / native_s, 1),
         "byte_identical": True},
    ]

    t = engine.init(1, device=dev)
    t._log = engine.OpLog()
    t._log.extend_packed(p)
    t._packed = p
    for compress in (True, False):
        t0 = time.perf_counter()
        buf = io.BytesIO()
        t.checkpoint_packed(buf, compress=compress)
        t1 = time.perf_counter()
        rows.append({"metric": "egress_bootstrap_1M",
                     "path": "snapshot_npz" + ("" if compress else "_raw"),
                     "seconds": round(t1 - t0, 3),
                     "bytes": buf.getbuffer().nbytes})
    block = _headline.device_block(dev)
    out = {"bench": "egress", "n_ops": len(ops),
           "host": _headline.platform_tag(block), "device": block,
           "rows": rows}
    _headline.write(out, out_path or _headline.out_path("egress"))
    return out


def main(argv=None) -> int:
    device, argv = _headline.split_device(
        list(sys.argv[1:] if argv is None else argv))
    out = run(int(argv[0]) if argv else 1_000_000, device=device)
    for row in out["rows"]:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
