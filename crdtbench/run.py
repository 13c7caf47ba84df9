"""Run one cell of the benchmark once.

    python3 -m crdtbench --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Reads the cell from ``BENCHMARK.json`` at the checkout's root, its
configuration from the file named there and its traffic from
``crdtbench/traffic/<config>.<traffic>.json`` under the same root; the
traffic names the driver (``crdtbench/drivers/``) that runs it.  Set-up (imports, the
card, the kernels' build or load, the inputs from the seed, the warm-up)
is timed on the host's clock; then the driver runs one measured window
of ``--seconds``.  ``--trace 1`` profiles the window's first
``crdtbench.trace.SECONDS`` (a fixed sub-window) and reports the cell's
per-layer metrics from it instead of its end-to-end ones; a trace whose
device line falls quiet well before that sub-window closes is refused.  After the
window the peak memory is read, the program's state is freed, and the
outputs the window produced are compared with the plain reference
(``crdtbench/reference``).  Each metric is read by its own reader,
``crdtbench/metrics/<metric>.py``.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its
limit); the numbers compared are also the last lines of standard error.
With no CUDA device, too few of them, a trace that stopped recording,
or JAX or the JAX package loaded when the window has closed, it prints
no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

T_PROCESS = time.perf_counter()

HERE = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "crdt_graph_tpu")


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its own kernels under ``build/`` already)."""
    base = root / "build" / "crdtbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


def banned_loaded() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``crdt_graph_tpu_torch`` is not
    ``crdt_graph_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(BANNED))


def load_cell(root: Path, workload: str) -> dict:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"crdtbench: no workload {workload!r}")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    mix = f"{cell['config']}.{cell['traffic']}.json"
    traffic = json.loads((root / "crdtbench" / "traffic" / mix).read_text())

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def read_metric(name: str, rec: dict):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"crdtbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def parse(argv):
    ap = argparse.ArgumentParser(prog="crdtbench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None, root=None, adjust=None) -> int:
    """Run one cell; ``device`` (tests only) names a device instead of
    looking for the card, and ``adjust(config, traffic)`` may resize the
    cell for a test run."""
    args = parse(argv)
    root = Path(root) if root else HERE.parent
    cache_dirs(root)
    spec = load_cell(root, args.workload)
    if adjust is not None:
        adjust(spec["config"], spec["traffic"])
    chips = spec["cell"]["chips"]

    import torch
    torch.set_num_threads(1)
    on_card = device is None
    if on_card:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < chips:
            print(f"crdtbench: the cell needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 3
        device = torch.device("cuda")
        torch.cuda.reset_peak_memory_stats()
    trace = bool(args.trace)

    from . import drivers
    from .trace import Tracer, stopped_recording, top
    drv = drivers.load(spec["traffic"]["driver"])(
        spec["config"], spec["traffic"], args.seed, device, trace)
    t_ready = time.perf_counter()
    drv.setup()
    if on_card:
        torch.cuda.synchronize()
    rec = {"setup_s": time.perf_counter() - T_PROCESS}
    phases = {"torch and card": t_ready - T_PROCESS,
              **getattr(drv, "setup_phases", {})}
    print("crdtbench: set-up s " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
    tracer = Tracer(drv.spans()) if trace else None
    rec["window"] = drv.window(args.seconds, tracer)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    win = rec["window"]
    print(f"crdtbench: {win['attempted']} attempted in "
          f"{win['window_s']:.3f} s; merge fallbacks in the window: "
          f"{win.get('fallbacks', 'not counted')}", file=sys.stderr)
    if getattr(drv, "summary", None):
        print(f"crdtbench: {drv.summary}", file=sys.stderr)
    if trace:
        rec["profile"] = tracer.reduce()
        rec["audit"] = drv.audit()
        rec["kernel_bound_ms"] = drv.kernel_bound_ms()
        p = rec["profile"]
        print(f"crdtbench: traced {p['window_s']:.3f} s, "
              f"{len(win['traced_ops'])} steps; profiler device events "
              f"{p['device_events']}, the last {p['quiet_tail_s']:.3f} s "
              f"before the close; audit "
              f"{json.dumps(rec['audit'], default=str)}", file=sys.stderr)
        if on_card and stopped_recording(p):
            print("crdtbench: the profiler stopped recording inside the "
                  "traced window", file=sys.stderr)
            return 5

    drv.host_tables()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    counts, compared, missing = drv.check()
    checks = {k: {"value": v, "limit": 0} for k, v in counts.items()}
    checks["failed_calls"] = {"value": win["failed"], "limit": 0}
    checks["answers_missing"] = {"value": missing, "limit": 0}
    correct = compared > 0 and all(c["value"] <= c["limit"]
                                   for c in checks.values())

    listed = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in listed:
        v = read_metric(m["name"], rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else str(device),
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": win["attempted"],
            "failed": win["failed"], "metrics": metrics, "device": dev}
    if trace:
        p = rec["profile"]
        dev["busy_s"] = p["busy_s"]
        dev["window_s"] = p["window_s"]
        line["breakdown"] = {"device_ops": top(p["device_ops_s"]),
                             "idle_gaps": top(p["idle_gaps_s"])}
    line["checks"] = checks

    found = banned_loaded()
    if found:
        print(f"crdtbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 4
    if getattr(drv, "error", None):
        print(f"crdtbench: a step failed: {drv.error}", file=sys.stderr)
    print(f"crdtbench: compared {compared} answers", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
