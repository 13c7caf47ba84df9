"""Where a merge's time goes on the card.

    python -m crdt_graph_tpu_torch.bench.profile [--ops N] [--replicas R]

Runs the config-5 chain join (``workloads.chain_workload``) through
``ops.merge.materialize`` in the vouched ``hints="exhaustive"`` mode on
the CUDA device and reports, as one JSON
line (also written to ``build/profile_merge.json``):

- ``stage_ms``: the honest p50 of the ``probe=k`` cut for k = 1..7 and of
  the full merge (each cut stops after stage k and reads back the
  cumulative checksum), so consecutive differences price the stages;
- ``h2d_ms``: the host→device copy of the merge's columns alone;
- ``profile``: one ``torch.profiler`` window over three merges — device
  time summed by kernel name, launches per merge, and the device's busy
  and idle share of the window's wall time;
- ``host_syncs``: predicate read-backs per merge;
- ``audit``: the trace audit (``utils.chainaudit``) of one more merge of
  the same columns: device ops, memory passes, kernel calls and host
  syncs (hidden ones too), by stage — the counts beside the profiler's
  device times.

Needs a CUDA device; it never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from .. import convert
from ..ops import merge
from . import honest, workloads


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def run(n_ops: int, n_replicas: int, repeats: int = 7) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile needs a CUDA device")
    from ..kernels import build
    build.load()
    dev = torch.device("cuda")
    arrs = workloads.chain_workload(n_replicas, n_ops)
    out = {"device": torch.cuda.get_device_name(0), "ops": n_ops,
           "replicas": n_replicas}

    def h2d():
        cols = convert.ops_from_numpy(
            {k: arrs[k] for k in merge.MERGE_COLS if k in arrs}, dev)
        torch.cuda.synchronize()
        return cols
    h2d()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        h2d()
        times.append((time.perf_counter() - t0) * 1e3)
    out["h2d_ms"] = sorted(times)[len(times) // 2]

    def merge_once(probe=None):
        return merge.materialize(arrs, hints="exhaustive", device=dev,
                                 probe=probe)

    stage = {}
    for k in (1, 2, 3, 4, 5, 6, 7, None):
        fn = (lambda k=k: torch.tensor(merge_once(k))) \
            if k is not None else merge_once
        stage["full" if k is None else str(k)] = \
            honest.time_with_readback(fn, repeats=repeats)["p50_ms"]
    out["stage_ms"] = stage

    merge.host_syncs = 0
    merge_once()
    torch.cuda.synchronize()
    out["host_syncs"] = merge.host_syncs

    from torch.profiler import ProfilerActivity, profile
    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            merge_once()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    launches = 0
    for evt in prof.events():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            launches += 1
            by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + \
                _device_us(evt)
    if not by_kernel:       # older event API: fall back to the averages
        for evt in prof.key_averages():
            us = _device_us(evt)
            if us > 0:
                by_kernel[evt.key] = us
    busy_ms = sum(by_kernel.values()) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    out["profile"] = {
        "merges": n_prof,
        "wall_ms_per_merge": wall_ms / n_prof,
        "device_busy_ms_per_merge": busy_ms / n_prof,
        "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
        "device_ops_per_merge": launches / n_prof,
        "top_kernels_us_per_merge": [(name[:90], us / n_prof)
                                     for name, us in top],
    }
    from ..utils import chainaudit
    audit = chainaudit.audit_materialize(arrs, "exhaustive", True, dev)
    out["audit"] = {**audit.summary(), "by_stage": audit.by_stage()}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ops", type=int, default=1_000_000)
    ap.add_argument("--replicas", type=int, default=64)
    args = ap.parse_args()
    out = run(args.ops, args.replicas)
    root = Path(__file__).resolve().parents[2] / "build"
    root.mkdir(exist_ok=True)
    (root / "profile_merge.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
