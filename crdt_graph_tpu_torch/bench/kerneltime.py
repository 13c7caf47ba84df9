"""Kernel times on the card: device time, event time and host time a call.

A kernel's wrapper can outlast its kernel, so each function is timed by
three clocks, and the kernel itself by a fourth:

- ``device_ms``: the card's own time a call, the spans of everything the
  function ran on the device (kernels, fills, copies) summed by
  ``torch.profiler`` over ``reps`` back-to-back calls: the L2 cache holds
  what the last call left in it;
- ``events_ms``: CUDA events around ``reps`` back-to-back calls, over
  ``reps``: the larger of the host's and the device's work a call;
- ``host_us``: the host's wall time of ``n`` calls with no
  synchronisation, over ``n``: what a call costs the calling thread;
- ``cold_ms`` (the kernel only): CUDA events around one call queued
  behind a read of a buffer twenty times the L2, so the call finds none
  of its inputs in the L2 and the host has issued it before the card
  reaches it; the mean of ``reps``.  The bound share is taken on it.

``chip_smoke.py`` times every kernel with these.  Run as a program, it
compares checkouts of the port on one card in one command:

    python -m crdt_graph_tpu_torch.bench.kerneltime \
        --roots build/parent . . build/parent

For each root in turn (one process each, that root's package and
kernels), it captures the arguments of kernels 3 and 4 from the merge's
main path (config 5 at 1M ops, ``hints="exhaustive"``) and kernel 1's
at three widths (:func:`kernel1_inputs`: C = 2 on the main path, 3 and
17), makes kernel 5's from a seed (:func:`ring_inputs`), and times each
kernel, its twin and its library call, and kernel 4 again with seven
value rows (the merge's V when two weight lanes exist).  One JSON line a
root, also appended to ``build/kerneltime.jsonl``.  Needs a CUDA device.

``csrc/variants/mono_gather_staged.cu`` is kernel 4 with its monotone
window staged in shared memory; it is timed against the checkout in a
copy of the package that builds it in place of ``csrc/mono_gather.cu``:

    mkdir -p build/staged
    cp -r crdt_graph_tpu_torch tests build/staged/
    cp crdt_graph_tpu_torch/csrc/variants/mono_gather_staged.cu \
        build/staged/crdt_graph_tpu_torch/csrc/mono_gather.cu
    python -m crdt_graph_tpu_torch.bench.kerneltime \
        --roots . build/staged build/staged .

Kernel 1's two alternatives to ``csrc/plane_rows.cu`` are timed the same
way: plain stores in place of its evict-first ones
(``PLANE_ROWS_STREAMING_STORES`` set to 0) and
``csrc/variants/plane_rows_shfl.cu`` (each row's index broadcast by warp
shuffle), each built in a copy in place of the checkout's file:

    mkdir -p build/plain build/shfl
    cp -r crdt_graph_tpu_torch tests build/plain/
    cp -r crdt_graph_tpu_torch tests build/shfl/
    sed -i 's/STREAMING_STORES 1/STREAMING_STORES 0/' \
        build/plain/crdt_graph_tpu_torch/csrc/plane_rows.cu
    cp crdt_graph_tpu_torch/csrc/variants/plane_rows_shfl.cu \
        build/shfl/crdt_graph_tpu_torch/csrc/plane_rows.cu
    python -m crdt_graph_tpu_torch.bench.kerneltime \
        --roots build/parent . build/plain build/shfl . build/parent

This module imports only torch at its top: a run loads it by file path
beside an older checkout's package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
INT_OPS_PER_S = 67e12          # non-tensor-core 32-bit rate (fp32 figure)
N_OPS = 1_000_000              # config 5, the merge's main path
FLUSH_BYTES = 1 << 30          # read before a cold call: 20x the H100's L2


def events_ms(fn, reps: int = 20) -> float:
    """Mean time a call of ``fn`` by CUDA events around ``reps``
    back-to-back calls (after one warm-up)."""
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


# profiler sessions tried before device_ms gives up: a session now and
# then hands back no device events at all for work that ran.  Sessions
# that start more than about a minute after the process's first
# profiler session hand back none at all (NVIDIA H100, torch 2.11), so
# a process keeps its profiler sessions together
PROFILE_TRIES = 3
# sessions that recorded no device time and were taken again, this process
empty_sessions = 0


def device_ms(fn, reps: int = 20, by_name: dict = None) -> float:
    """Device time a call of ``fn``: the spans of everything it ran on the
    card summed over ``reps`` calls by ``torch.profiler``, over ``reps``.
    ``by_name``, when given, receives the same time split by the name of
    each span (kernels, fills, copies).  A session that records no device
    time is taken again, up to ``PROFILE_TRIES`` sessions in all; then it
    raises."""
    global empty_sessions
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [(ev.name, ev.time_range.elapsed_us())
                 for ev in prof.events()
                 if getattr(ev, "device_type", None) == cuda]
        us = sum(t for _, t in spans)
        if us:
            break
        empty_sessions += 1
    else:
        raise RuntimeError(f"the profiler recorded no device time in "
                           f"{PROFILE_TRIES} sessions")
    if by_name is not None:
        for name, t in spans:
            by_name[name] = by_name.get(name, 0.0) + t / reps / 1e3
    return us / reps / 1e3


def cold_ms(fn, reps: int = 20) -> float:
    """Time a call of ``fn`` takes on the card with its inputs out of the
    L2: CUDA events around each call, queued behind a read of
    ``FLUSH_BYTES`` (which evicts the L2, leaves no dirty line behind,
    and outlasts the host's issue of the call); the mean of ``reps``."""
    flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    for s, e in ev:
        flush.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    del flush
    return sum(s.elapsed_time(e) for s, e in ev) / reps


def host_us(fn, n: int = 50, rounds: int = 5) -> float:
    """Host wall time a call of ``fn``, in microseconds: the median over
    ``rounds`` of ``n`` calls with no synchronisation between them (after
    a warm-up), each round over ``n`` — the median, because other work on
    a shared host lengthens single rounds."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        per.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return sorted(per)[len(per) // 2]


def clocks(fn, cold: bool = False) -> dict:
    """The clocks for ``fn``, ``cold_ms`` too when asked (None for a
    missing function)."""
    if fn is None:
        return {"device_ms": None, "events_ms": None, "host_us": None,
                "cold_ms": None, "device_by_name": {}}
    names = {}
    return {"device_ms": device_ms(fn, by_name=names),
            "events_ms": events_ms(fn), "host_us": host_us(fn),
            "cold_ms": cold_ms(fn) if cold else None,
            "device_by_name": names}


def bound_ms(nbytes: int, nops: int = 0):
    """The least time the card could take: the larger of the bytes over
    its memory rate and the operations over its 32-bit rate; and which."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def launch_floor_ms() -> float:
    """The launch floor on the bound share's own clock: the cold time
    (:func:`cold_ms`) of a one-element ``torch.add`` on the card."""
    x = torch.ones(1, dtype=torch.int32, device="cuda")
    return cold_ms(lambda: torch.add(x, x))


def work_of(kname: str, args):
    """(bytes, operations) the kernel's function must do for these
    inputs: each input element it needs read once, each output written
    once.  A batched form's work is its documents' summed (each reads
    only its own plane)."""
    if kname == "prefix_sums_batched":
        return work_of("prefix_sums", args)
    if kname.endswith("_batched"):
        one = kname[:-len("_batched")]
        nb = nops = 0
        for b in range(int(args[0].shape[0])):
            w = work_of(one, (args[0][b], args[1][b]) + tuple(args[2:]))
            nb, nops = nb + w[0], nops + w[1]
        return nb, nops
    if kname in ("plane_rows", "plane_rows2"):
        from crdt_graph_tpu_torch.ops import fused_resolve as fr
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
    if kname == "ring_exclusive":
        # the k - 1 carry vectors some output depends on (shard k - 1's
        # feeds none) read once, k results written once; an exclusive
        # scan needs k - 2 combines per lane
        vals = args[0]
        k, lanes = len(vals), int(vals[0].shape[0])
        return 4 * (k - 1) * lanes + 4 * k * lanes, max(k - 2, 0) * lanes
    vals, rid = args
    used = torch.unique(rid.long())
    v, t = vals.shape[0], rid.shape[0]
    return 4 * t + 4 * v * int(used.numel()) + 4 * v * t, 0


def library(kname: str, args):
    """One PyTorch call computing the same function (a yardstick only; the
    port never calls it), or None."""
    dev = args[0][0].device if kname == "ring_exclusive" else args[0].device
    if kname == "plane_rows":
        # the fastest of :func:`library_variants`: a row gather launches
        # one block a row, so two-column planes gather as 16-byte
        # elements
        plane, idx = args
        if plane.shape[1] == 2:
            flat = plane.view(torch.complex128).view(-1)
            return lambda: torch.index_select(flat, 0, idx)
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
    if kname == "plane_rows_batched":
        # one gather of rows over the leading document axis (the index
        # widened and broadcast over the columns beforehand)
        plane, idx = args
        wide = idx.long()[:, :, None].expand(-1, -1, plane.shape[2])
        return lambda: torch.gather(plane, 1, wide)
    if kname == "prefix_sums_batched":
        b, w = args
        stacked = torch.zeros((b.shape[0], 1 + w.shape[1], b.shape[1]),
                              dtype=torch.int32, device=dev)
        stacked[:, 0] = b
        stacked[:, 1:, :w.shape[2]] = w
        return lambda: torch.cumsum(stacked, 2, dtype=torch.int32)
    if kname == "monotone_gather_batched":
        vals, rid = args
        wide = rid.long()[:, None, :].expand(-1, vals.shape[1], -1)
        return lambda: torch.gather(vals, 2, wide)
    if kname == "ring_exclusive":
        # one cumsum over the zero-prepended [k + 1, L] stack: row i is
        # shard i's exclusive sum
        vals = args[0]
        stacked = torch.zeros((len(vals) + 1, vals[0].shape[0]),
                              dtype=torch.int32, device=dev)
        stacked[1:] = torch.stack(vals)
        return lambda: torch.cumsum(stacked, 0, dtype=torch.int32)
    return None


def library_variants(kname: str, args) -> dict:
    """Kernel 1's candidate library calls on ``args``, by name (empty for
    the other kernels): ``index_select`` of rows with the int32 index,
    and with the index widened to int64 beforehand (whether the index's
    type matters); and, for a two-column plane, ``index_select`` on the
    plane viewed as one 16-byte element a row (two int64 columns as one
    complex128), a one-dimensional gather, which PyTorch launches
    another way than a gather of rows (:func:`library`'s call)."""
    if kname != "plane_rows":
        return {}
    plane, idx = args
    out = {"index_select_i32": lambda: torch.index_select(plane, 0, idx)}
    wide = idx.long()
    out["index_select_i64"] = lambda: torch.index_select(plane, 0, wide)
    if plane.shape[1] == 2:
        flat = plane.view(torch.complex128).view(-1)
        out["index_select_rows_as_c128"] = \
            lambda: torch.index_select(flat, 0, idx)
    return out


def time_kernel(kname: str, call, twin, args) -> dict:
    """The kernel's, its twin's and its library call's clocks on
    ``args``, with the bound (bytes and operations), the bound share
    (bound over the kernel's cold time) and the library ratio (by device
    time); and the bound with the launch floor measured in the same call
    on the same cold clock (``launch_floor_ms``, ``floor_bound_ms``) and
    its share of the kernel's cold time (``floor_share``)."""
    nb, nops = work_of(kname, args)
    b_ms, b_by = bound_ms(nb, nops)
    rec = {"kernel": clocks(lambda: call(*args), cold=True),
           "plain": clocks(lambda: twin(*args)),
           "library": clocks(library(kname, args)),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nb}
    k_dev, l_dev = rec["kernel"]["device_ms"], rec["library"]["device_ms"]
    rec["bound_share"] = b_ms / rec["kernel"]["cold_ms"]
    floor = launch_floor_ms()
    # no launch takes less than the floor: the bound's third term
    f_ms = max(b_ms, floor)
    rec.update({"launch_floor_ms": floor, "floor_bound_ms": f_ms,
                "floor_share": f_ms / rec["kernel"]["cold_ms"]})
    rec["library_ratio"] = k_dev / l_dev if l_dev else None
    return rec


# ---- comparing checkouts ---------------------------------------------------

def capture_calls(fn, targets) -> dict:
    """Run ``fn`` with each wrapper ``(module, name)`` of ``targets``
    recording a copy of the arguments of every call; return {name:
    [args, ...]}."""
    seen = {}
    saved = []
    for mod, name in targets:
        orig = getattr(mod, name)

        def rec(*a, _orig=orig, _name=name):
            seen.setdefault(_name, []).append(
                tuple(x.clone() if hasattr(x, "clone") else x for x in a))
            return _orig(*a)
        saved.append((mod, name, orig))
        setattr(mod, name, rec)
    try:
        fn()
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    return seen


def kernel1_inputs(dev) -> dict:
    """Kernel 1's arguments at three widths, captured from 1M-op merges:
    ``plane_rows``, the delete leg's target gather of config 5 with every
    16th node deleted (the main path's vouched merge: C = 2);
    ``plane_rows_c3``, the node frame of the same batch's unvouched merge
    (C = 3, odd); ``plane_rows_c17``, the parent frame of config 8's
    unvouched merge (C = 17).  {key: (plane, idx)}."""
    from crdt_graph_tpu_torch.bench import workloads
    from crdt_graph_tpu_torch.ops import fused_resolve, merge
    dels = workloads.chain_with_deletes(N_OPS, 16, 64)
    deep = workloads.deep_paths(64, N_OPS)
    out = {}
    for key, arrs, hints, cols in (
            ("plane_rows", dels, "exhaustive", 2),
            ("plane_rows_c3", dels, None, 3),
            ("plane_rows_c17", deep, None, 17)):
        seen = capture_calls(
            lambda: merge.materialize(arrs, hints=hints, device=dev),
            [(fused_resolve, "plane_rows")])
        out[key] = next(a for a in seen["plane_rows"]
                        if a[0].shape[1] == cols)
    torch.cuda.synchronize()
    return out


def ring_inputs(dev, k: int = 8, lanes: int = 3, seed: int = 0):
    """Kernel 5's arguments at the ops-axis merge's shape: k carry
    vectors of ``lanes`` int32 lanes on one card, from a seed."""
    g = torch.Generator().manual_seed(seed)
    return ([torch.randint(-2**31, 2**31 - 1, (lanes,), generator=g,
                           dtype=torch.int32).to(dev) for _ in range(k)],)


def child(root: str) -> dict:
    """Kernels 3 and 4 of the package under ``root``, timed at the merge's
    main-path inputs, and kernel 4 with seven value rows; kernel 1 at the
    widths of :func:`kernel1_inputs`; kernel 5 at :func:`ring_inputs`."""
    from crdt_graph_tpu_torch.bench import workloads
    from crdt_graph_tpu_torch.kernels import build
    from crdt_graph_tpu_torch.ops import (fused_resolve, merge, mono_gather,
                                          tour_scan)
    mods = {"prefix_sums": (tour_scan, tour_scan.plain_prefix),
            "monotone_gather": (mono_gather, mono_gather.plain_gather),
            "plane_rows": (fused_resolve, fused_resolve.plain_rows),
            "ring_exclusive": (tour_scan, tour_scan.plain_ring_exclusive)}
    t0 = time.perf_counter()
    build.load()
    build_s = time.perf_counter() - t0
    arrs = workloads.chain_workload(64, N_OPS)
    seen = capture_calls(
        lambda: merge.materialize(arrs, hints="exhaustive", device="cuda"),
        [(tour_scan, "prefix_sums"), (mono_gather, "monotone_gather")])
    torch.cuda.synchronize()
    out = {"root": root, "build_s": build_s, "kernels": {}}
    vals, rid = seen["monotone_gather"][0]
    cases = [(name, name, seen[name][0])
             for name in ("prefix_sums", "monotone_gather")]
    cases.append(("monotone_gather_v7", "monotone_gather",
                  (torch.cat([vals, vals[:3]]), rid)))
    cases += [(key, "plane_rows", args)
              for key, args in kernel1_inputs("cuda").items()]
    cases.append(("ring_exclusive", "ring_exclusive", ring_inputs("cuda")))
    for key, name, args in cases:
        mod, twin = mods[name]
        call = getattr(mod, name)
        got, want = call(*args), twin(*args)
        got = tuple(got) if isinstance(got, (tuple, list)) else (got,)
        want = tuple(want) if isinstance(want, (tuple, list)) else (want,)
        rec = time_kernel(name, call, twin, args)
        rec["equal_twin"] = len(got) == len(want) and \
            all(torch.equal(g, w) for g, w in zip(got, want))
        rec["shapes"] = [list(a.shape) for a in args if hasattr(a, "shape")]
        out["kernels"][key] = rec
    return out


def card_line() -> str:
    """The first card's name and power limit as ``nvidia-smi`` gives
    them (``"NVIDIA H100 80GB HBM3, 700.00 W"``): the tag every number
    taken on the card carries, since a card set below its maximum power
    runs slower under load."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=["."],
                    help="checkout roots, timed in this order, one process "
                         "each")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kerneltime: no CUDA device", file=sys.stderr)
        return 2
    if opts.child:
        print(json.dumps(child(opts.child)), flush=True)
        return 0
    card = card_line()
    print(card, flush=True)
    here = str(Path(__file__).resolve())
    log = Path.cwd() / "build" / "kerneltime.jsonl"
    log.parent.mkdir(exist_ok=True)
    rc = 0
    for i, root in enumerate(opts.roots):
        root = str(Path(root).resolve())
        # this file, loaded by path beside the root's package
        code = (
            "import importlib.util, sys; sys.path.insert(0, sys.argv[1]);"
            f"s = importlib.util.spec_from_file_location('_kt', {here!r});"
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m);"
            "sys.exit(m.main(['--child', sys.argv[1]]))")
        p = subprocess.run([sys.executable, "-c", code, root],
                           cwd=root, capture_output=True, text=True)
        if p.returncode != 0:
            print(p.stdout + p.stderr, file=sys.stderr)
            rc = 1
            continue
        line = json.loads(p.stdout.strip().splitlines()[-1])
        line.update({"turn": i, "card": card})
        with log.open("a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
