#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``crdt_graph_tpu_torch/csrc`` with
``nvcc`` (sm_90a), holds each kernel against its plain PyTorch twin at
the merge's real shapes (exact equality: integer data), drives the main
path — ``crdt_graph_tpu_torch.ops.merge.materialize`` on the 64-replica,
1M-op chain join (config 5), and the same batch with every 16th node
deleted — and checks the converged order against its closed form, the
launch count of every kernel on that path, and bit-identity of configs
1-4 and 6-8 between the card and the port's CPU path.  Then it times the
merge and each kernel.

Exits non-zero, printing no result, without a CUDA device or without
the package beside it.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels
with their launches, errors and times.  The full record also goes to
``build/chip_smoke.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
INT_OPS_PER_S = 67e12          # non-tensor-core 32-bit rate (fp32 figure)
N_OPS = 1_000_000
N_REPLICAS = 64
DEL_EVERY = 16
DEVICE = "cuda"

KERNELS = {
    "plane_rows": ("crdt_graph_tpu_torch/csrc/plane_rows.cu",
                   "crdt_graph_tpu/ops/fused_resolve.py:304"),
    "plane_rows2": ("crdt_graph_tpu_torch/csrc/plane_rows.cu",
                    "crdt_graph_tpu/ops/fused_resolve.py:217"),
    "prefix_sums": ("crdt_graph_tpu_torch/csrc/prefix_sums.cu",
                    "crdt_graph_tpu/ops/tour_scan.py:271"),
    "monotone_gather": ("crdt_graph_tpu_torch/csrc/mono_gather.cu",
                        "crdt_graph_tpu/ops/mono_gather.py:102"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events,
    after one warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def max_abs_err(got, want) -> float:
    """Largest |got - want| over the outputs (float64; 0 iff equal)."""
    import torch
    err = 0.0
    for g, w in zip(got, want):
        if not torch.equal(g.cpu(), w.cpu()):
            err = max(err, float((g.cpu().double() -
                                  w.cpu().double()).abs().max()))
    return err


def bound_ms(nbytes: int, nops: int = 0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def capture_inputs(fn, modules):
    """Run ``fn`` with every kernel wrapper of ``modules`` recording its
    arguments; return {name: [args, ...]}."""
    seen = {}
    saved = []
    for mod, name in modules:
        orig = getattr(mod, name)

        def rec(*args, _orig=orig, _name=name):
            seen.setdefault(_name, []).append(
                tuple(a.clone() if hasattr(a, "clone") else a
                      for a in args))
            return _orig(*args)
        saved.append((mod, name, orig))
        setattr(mod, name, rec)
    try:
        fn()
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    return seen


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from crdt_graph_tpu_torch import convert, kernels
    from crdt_graph_tpu_torch.bench import honest, workloads
    from crdt_graph_tpu_torch.codec import packed
    from crdt_graph_tpu_torch.kernels import build
    from crdt_graph_tpu_torch.ops import fused_resolve as fr
    from crdt_graph_tpu_torch.ops import merge, mono_gather as mg, \
        tour_scan as ts, view

    dev = torch.device(DEVICE)
    record = {"kernels": {}, "phases": {}}

    # ---- 1. the card --------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(card)
    name = torch.cuda.get_device_name(0)
    record["card"] = card
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    build.load()
    record["phases"]["build_s"] = time.perf_counter() - t0
    log(f"build: {record['phases']['build_s']:.2f} s "
        f"({build.BUILD_ROOT})")
    for line in build.ptxas_log.splitlines():
        if "registers" in line or line.startswith("=="):
            log("  " + line.strip())

    # ---- inputs of the main path (config 5, and with deletes) ---------
    t0 = time.perf_counter()
    adds = workloads.chain_workload(N_REPLICAS, N_OPS)
    dels = workloads.chain_with_deletes(N_OPS, DEL_EVERY, N_REPLICAS)
    record["phases"]["gen_s"] = time.perf_counter() - t0
    log(f"workloads: config 5 ({adds['kind'].shape[0]} ops) and config 5 "
        f"with every {DEL_EVERY}th node deleted ({dels['kind'].shape[0]} "
        f"ops) in {record['phases']['gen_s']:.2f} s")
    wrappers = [(fr, "plane_rows"), (fr, "plane_rows2"),
                (ts, "prefix_sums"), (mg, "monotone_gather")]
    caught = capture_inputs(
        lambda: (merge.materialize(adds, device=dev),
                 merge.materialize(dels, device=dev)), wrappers)
    torch.cuda.synchronize()

    # ---- 3. each kernel against its twin ------------------------------
    rng = np.random.default_rng(0)
    twins = {"plane_rows": fr.plain_rows, "plane_rows2": fr.plain_rows2,
             "prefix_sums": ts.plain_prefix,
             "monotone_gather": mg.plain_gather}
    calls = {"plane_rows": fr.plane_rows, "plane_rows2": fr.plane_rows2,
             "prefix_sums": ts.prefix_sums,
             "monotone_gather": mg.monotone_gather}

    def edge_cases(kname, args):
        """Synthetic inputs at the main-path shapes: negative hops,
        indices far outside any 1152-row window, out-of-range and
        negative indices, ragged last blocks."""
        if kname in ("plane_rows", "plane_rows2"):
            plane = args[0].clone()
            r = plane.shape[0]
            idx = torch.from_numpy(rng.permutation(r).astype(np.int32))
            idx[:8] = torch.tensor([-1, -r, -r - 5, r, r + 99,
                                    2**31 - 1, -2**31, 0], dtype=torch.int32)
            out = [(plane, idx.to(dev)) + tuple(args[2:])]
            if kname == "plane_rows2":
                hc = args[2]
                far = plane.clone()
                far[:, hc] = torch.from_numpy(
                    rng.integers(-r // 4, r + 7, r)).to(dev)
                out.append((far, idx.to(dev), hc))
            # ragged: one row fewer than a 256-thread block multiple
            t = (idx.shape[0] // 256) * 256 - 1
            out.append((args[0], args[1][:t].contiguous()) + tuple(args[2:]))
            return out
        if kname == "prefix_sums":
            b, w = args
            out = []
            for kw in (1, 2):
                out.append((torch.from_numpy(rng.integers(
                    0, 2, b.shape[0] - 3).astype(np.int32)).to(dev),
                    torch.from_numpy(rng.integers(
                        -5, 9, (kw, w.shape[1] + 1)).astype(np.int32))
                    .to(dev)))
            return out
        vals, rid = args
        out = []
        for v in (4, 7):
            vv = torch.from_numpy(rng.integers(
                -2**31, 2**31 - 1, (v, vals.shape[1]),
                dtype=np.int64).astype(np.int32)).to(dev)
            bad = rid.clone()
            bad[:4] = torch.tensor([-1, -3, vals.shape[1], 2**31 - 1],
                                   dtype=torch.int32)
            out.append((vv, bad[:-5].contiguous()))
        return out

    for kname in KERNELS:
        cases = caught.get(kname, [])
        if not cases:
            raise RuntimeError(f"the main path never called {kname}")
        errs, shapes = [], []
        for args in cases + edge_cases(kname, cases[0]):
            got = calls[kname](*args)
            cpu_args = tuple(a.cpu() if hasattr(a, "cpu") else a
                             for a in args)
            want = twins[kname](*cpu_args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            errs.append(max_abs_err(got, want))
            shapes.append([list(a.shape) for a in args if hasattr(a, "shape")])
        err = max(errs)
        record["kernels"][kname] = {"max_abs_err": err,
                                    "checked_shapes": shapes}
        log(f"kernel {kname}: {len(errs)} cases vs twin, max_abs_err {err}")
        if err != 0:
            raise RuntimeError(f"{kname} disagrees with its twin")

    # ---- 4. the main path, counted -------------------------------------
    kernels.reset_launches()
    merge.host_syncs = 0
    t_adds = merge.materialize(adds, device=dev)
    torch.cuda.synchronize()
    launches_adds = dict(kernels.launches)
    syncs_adds = merge.host_syncs
    t_dels = merge.materialize(dels, device=dev)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    syncs_dels = merge.host_syncs - syncs_adds
    log(f"main path launches: {launches} (config 5 alone: "
        f"{launches_adds}); host syncs per merge: {syncs_adds} "
        f"(adds), {syncs_dels} (with deletes)")
    for k in ("plane_rows2", "prefix_sums", "monotone_gather"):
        if launches_adds[k] < 1:
            raise RuntimeError(f"config 5 never launched {k}")
    for k, v in launches.items():
        if v < 1:
            raise RuntimeError(f"the main path never launched {k}")
    record["launches"] = launches
    record["launches_config5"] = launches_adds
    record["host_syncs"] = {"config5": syncs_adds,
                            "config5_deletes": syncs_dels}

    h = view.to_host(t_adds)
    exp = workloads.chain_expected_ts(N_REPLICAS, N_OPS)
    nv = int(h.num_visible)
    seq = h.ts[h.visible_order[:nv]]
    if nv != N_OPS or not np.array_equal(seq, exp):
        raise RuntimeError(f"config 5 order wrong (num_visible {nv})")
    if not (np.all(h.status[:N_OPS] == merge.APPLIED)):
        raise RuntimeError("config 5: some op not applied")
    hd = view.to_host(t_dels)
    gone = adds["ts"][np.arange(0, N_OPS, DEL_EVERY)]
    exp_d = exp[~np.isin(exp, gone)]
    nvd = int(hd.num_visible)
    seq_d = hd.ts[hd.visible_order[:nvd]]
    if not np.array_equal(seq_d, exp_d) or int(hd.num_nodes) != N_OPS:
        raise RuntimeError(f"config 5 with deletes wrong (num_visible "
                           f"{nvd}, want {exp_d.size})")
    log(f"config 5: {nv} visible in closed-form order; with deletes: "
        f"{nvd} visible, {int(hd.tombstone.sum())} tombstones, order "
        f"exact")
    del h, hd, t_adds, t_dels

    # configs 1-4 and 6-8 at reduced size: card == the port's CPU path
    reduced = {
        1: lambda: packed.pack(workloads.editor_replay(1000)).arrays(),
        2: lambda: packed.pack(
            workloads.two_replica_interleaved(10_000)).arrays(),
        3: lambda: packed.pack(workloads.nested_tree(100_000)).arrays(),
        4: lambda: packed.pack(workloads.tombstone_heavy(40_000)).arrays(),
        6: lambda: workloads.descending_chains(4096, 262_144),
        7: lambda: workloads.comb_pairs(262_144),
        8: lambda: workloads.deep_paths(64, 262_144),
    }
    record["configs"] = {}
    for cid, mk in reduced.items():
        arrs = mk()
        t0 = time.perf_counter()
        on_card = convert.table_to_numpy(merge.materialize(arrs, device=dev))
        t_card = time.perf_counter() - t0
        on_cpu = convert.table_to_numpy(merge.materialize(arrs,
                                                          device="cpu"))
        bad = [f for f in merge.FIELDS
               if on_card[f].dtype != on_cpu[f].dtype
               or not np.array_equal(on_card[f], on_cpu[f])]
        record["configs"][cid] = {"ops": int(arrs["kind"].shape[0]),
                                  "visible": int(on_card["num_visible"]),
                                  "mismatched_fields": bad}
        log(f"config {cid}: {arrs['kind'].shape[0]} ops, "
            f"{int(on_card['num_visible'])} visible, card == cpu: "
            f"{not bad} (first card call {t_card * 1e3:.1f} ms)")
        if bad:
            raise RuntimeError(f"config {cid}: card differs from cpu in "
                               f"{bad}")

    # ---- 5. timing ------------------------------------------------------
    t_np = honest.time_with_readback(
        lambda: merge.materialize(adds, device=dev), repeats=7)
    def h2d():
        cols = convert.ops_from_numpy(
            {k: adds[k] for k in merge.MERGE_COLS if k in adds}, dev)
        torch.cuda.synchronize()
        return cols
    h2d()
    t0 = time.perf_counter()
    dev_cols = h2d()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    t_del = honest.time_with_readback(
        lambda: merge.materialize(dels, device=dev), repeats=7)
    torch.cuda.reset_peak_memory_stats()
    del dev_cols
    merge.materialize(adds, device=dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    record["merge"] = {
        "config5_p50_ms": t_np["p50_ms"],
        "config5_times_ms": t_np["times_ms"],
        "config5_ops_per_s": N_OPS / (t_np["p50_ms"] / 1e3),
        "config5_h2d_copy_ms": h2d_ms,
        "config5_deletes_p50_ms": t_del["p50_ms"],
        "config5_deletes_times_ms": t_del["times_ms"],
        "peak_mem_bytes": peak,
    }
    log(f"merge config 5: p50 {t_np['p50_ms']:.3f} ms from numpy columns "
        f"({record['merge']['config5_ops_per_s']:.4g} ops/s), of which "
        f"host->device copy of the columns {h2d_ms:.3f} ms; with deletes "
        f"{t_del['p50_ms']:.3f} ms; peak device memory {peak} B")

    def bytes_of(kname, args):
        """Bytes the function must move for these inputs: each input
        element it needs read once, each output written once."""
        if kname in ("plane_rows", "plane_rows2"):
            plane, idx = args[0], args[1]
            r, c = plane.shape
            t = idx.shape[0]
            rows = fr.plain_rows(plane, idx)
            used = torch.unique(idx.long().clamp(0, r - 1))
            nb = 4 * t + 8 * c * t
            if kname == "plane_rows2":
                hop = rows[:, args[2]]
                used = torch.unique(torch.cat(
                    [used, hop[hop >= 0].clamp(max=r - 1)]))
                nb += 8 * c * t
            return nb + 8 * c * int(used.numel()), 0
        if kname == "prefix_sums":
            n = args[0].numel() + args[1].numel()
            return 8 * n, n
        vals, rid = args
        used = torch.unique(rid.long())
        v, t = vals.shape[0], rid.shape[0]
        return 4 * t + 4 * v * int(used.numel()) + 4 * v * t, 0

    def library(kname, args):
        """One PyTorch call computing the same function (a yardstick
        only; the port never calls it), or None."""
        if kname == "plane_rows":
            plane, idx = args
            return lambda: torch.index_select(plane, 0, idx)
        if kname == "prefix_sums":
            b, w = args
            stacked = torch.zeros((1 + w.shape[0], b.shape[0]),
                                  dtype=torch.int32, device=dev)
            stacked[0] = b
            stacked[1:, :w.shape[1]] = w
            return lambda: torch.cumsum(stacked, 1, dtype=torch.int32)
        if kname == "monotone_gather":
            vals, rid = args
            return lambda: torch.index_select(vals, 1, rid)
        return None

    rows = []
    for kname, (src, replaces) in KERNELS.items():
        args = caught[kname][0]
        k_ms = cuda_ms(lambda: calls[kname](*args))
        p_ms = cuda_ms(lambda: twins[kname](*args))
        lib = library(kname, args)
        l_ms = cuda_ms(lib) if lib is not None else None
        nb, nops = bytes_of(kname, args)
        b_ms, b_by = bound_ms(nb, nops)
        rec = record["kernels"][kname]
        rec.update({"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "bytes": nb,
                    "timed_shapes": [list(a.shape) for a in args
                                     if hasattr(a, "shape")]})
        log(f"time {kname} {rec['timed_shapes']}: kernel {k_ms:.4f} ms, "
            f"twin {p_ms:.4f} ms, library "
            f"{'-' if l_ms is None else f'{l_ms:.4f}'} ms, bound "
            f"{b_ms:.4f} ms ({nb} B)")
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[kname],
                     "max_abs_err": rec["max_abs_err"], "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": l_ms})

    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
