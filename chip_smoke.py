#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``crdt_graph_tpu_torch/csrc`` with
``nvcc`` (sm_90a) and, beside them, its native wire codec with ``g++``
(``crdt_graph_tpu_torch/native``), holds each kernel against its plain
PyTorch twin at the merge's real shapes (exact equality: integer data),
and drives three paths, each with the launch counts set to 0 just before
it and read just after:

- the merge: ``crdt_graph_tpu_torch.ops.merge.materialize`` in the
  vouched ``hints="exhaustive"`` mode on the 64-replica, 1M-op chain
  join (config 5), and the same batch with every 16th node deleted,
  checked against the closed form; configs 1-4 and 6-8 card == CPU;
- the replica engine (``crdt_graph_tpu_torch.engine.TpuTree``) at full
  size: a 1M-op bootstrap, a 200k-op anti-entropy delta in the serving
  scheduler's chunks, an interactive session of one-op remote applies
  and local edits (held to a bulk merge of the same log, and at 4,096
  ops to the oracle ``CRDTree``), an older-format restore that takes the
  sort+join on the card and a vouched one that does not, and a corrupt
  rank hint that falls back and equals ``hints="join"``;
- durable replicas at full size: the native codec round trip of the 1M
  ops; an 800k-op ingest by ``apply_wire`` into a tiered replica with a
  WAL, committed, appended and fsynced in the scheduler's chunks; a
  ``checkpoint_tiered`` with the matz artifact; a WAL-only 200k-op tail
  with deletes; a crash at ``mid-spill``; two recoveries
  (``restore_tiered`` + ``Wal.replay_into``: a full merge on the card,
  then from the matz artifact) held to a never-crashed replica field for
  field and byte for byte; the damage taxonomy (scrub quarantine, a
  broken manifest, a mid-log WAL flip, a torn final record).

Then it times the merge, each kernel, the engine's stages and the
merge's three hint legs.  Exits non-zero, printing no result, without a
CUDA device or without the package beside it.  The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels with their launches (all paths), errors and times.
The full record also goes to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
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

DEFAULT_CHUNK_OPS = 1 << 17    # the serving scheduler's chunk (serve/engine.py)
N_HEAD = 800_000               # rows a replica bootstraps before the delta
N_REMOTE, N_LOCAL = 256, 64    # the interactive session
N_SLICE = 65_536               # the corrupt-hint slice


def packed_chain(arrs, n):
    """A vouched ``PackedOps`` over config-5 arrays, whose values are the
    row numbers (so a visible value names its row)."""
    from crdt_graph_tpu_torch.codec import packed
    return packed.PackedOps(
        kind=arrs["kind"], ts=arrs["ts"], parent_ts=arrs["parent_ts"],
        anchor_ts=arrs["anchor_ts"], depth=arrs["depth"],
        paths=arrs["paths"], value_ref=arrs["value_ref"], pos=arrs["pos"],
        values=list(range(n)), num_ops=n, parent_pos=arrs["parent_pos"],
        anchor_pos=arrs["anchor_pos"], target_pos=arrs["target_pos"],
        ts_rank=arrs["ts_rank"], hints_vouched=True)


def session_steps(seed, pool):
    """The interactive session: 256 one-op remote adds (replica 200) and,
    every fifth step, a local edit (add after, or delete) — anchors and
    targets drawn from ``pool`` (timestamps present in the document),
    which grows with the session's own adds."""
    import random
    rng = random.Random(seed)
    pool = [int(x) for x in pool]
    steps, k = [], 0
    for i in range(N_REMOTE + N_LOCAL):
        if i % 5 == 4:
            steps.append(("add_after" if (i // 5) % 2 == 0 else "delete",
                          rng.choice(pool)))
        else:
            k += 1
            ts = 200 * 2**32 + k
            steps.append(("remote", ts, rng.choice(pool)))
            pool.append(ts)
    return steps


def run_session(tree, steps, Add, oracle=None):
    """Drive ``steps`` on an engine replica (and the oracle, when given);
    returns the per-op times of the remote applies (ms) and the oracle."""
    times = []
    for i, st in enumerate(steps):
        if st[0] == "remote":
            op = Add(st[1], (st[2],), f"r{i}")
            t0 = time.perf_counter()
            tree.apply(op)
            times.append((time.perf_counter() - t0) * 1e3)
            if oracle is not None:
                oracle = oracle.apply(op)
        elif st[0] == "add_after":
            tree.add_after((st[1],), f"l{i}")
            if oracle is not None:
                oracle = oracle.add_after((st[1],), f"l{i}")
        else:
            tree.delete((st[1],))
            if oracle is not None:
                oracle = oracle.delete((st[1],))
    return times, oracle


def engine_phase(dev, record, calls, twins):
    """The replica engine (``crdt_graph_tpu_torch.engine.TpuTree``) on the
    card at full size: bootstrap, bulk anti-entropy, interactive deltas,
    the unvouched and vouched restores, corrupt hints.  Raises on any
    mismatch.  Returns the kernel launches of the counted drive."""
    import io
    import numpy as np
    import torch
    from crdt_graph_tpu_torch import convert, engine, kernels
    from crdt_graph_tpu_torch.bench import honest, workloads
    from crdt_graph_tpu_torch.codec import packed
    from crdt_graph_tpu_torch.core.operation import Add, Batch
    from crdt_graph_tpu_torch.core.tree import CRDTree
    from crdt_graph_tpu_torch.host_tree import HostTree
    from crdt_graph_tpu_torch.ops import fused_resolve as fr, merge, view

    out = {}
    arrs = workloads.chain_workload(N_REPLICAS, N_OPS)
    full = packed_chain(arrs, N_OPS)
    ts_col = arrs["ts"]
    exp = workloads.chain_expected_ts(N_REPLICAS, N_OPS)
    head = packed.select_rows(full, np.arange(N_HEAD))
    rest = packed.select_rows(full, np.arange(N_HEAD, N_OPS))

    def closed_form(tree, what):
        vals = np.asarray(tree.visible_values(), dtype=np.int64)
        if vals.shape != exp.shape or not np.array_equal(ts_col[vals], exp):
            raise RuntimeError(f"engine {what}: visible order wrong "
                               f"({vals.size} visible)")

    def strip_hints(buf):
        """The checkpoint in the older format: no hint columns, no vouch."""
        z = np.load(io.BytesIO(buf))
        meta = json.loads(bytes(z["meta"]).decode())
        meta.pop("hints_vouched", None)
        cols = {k: z[k] for k in z.files if k not in
                ("parent_pos", "anchor_pos", "target_pos", "ts_rank",
                 "meta")}
        cols["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
        o = io.BytesIO()
        np.savez(o, **cols)
        return o.getvalue()

    def snap():
        return dict(kernels.launches)

    def delta(a, b):
        return {k: b[k] - a[k] for k in b}

    torch.cuda.reset_peak_memory_stats()
    # ---- the counted drive -------------------------------------------
    kernels.reset_launches()
    merge.host_syncs = 0
    merge.fallbacks = 0
    steps_l = {}

    # 1. bootstrap: one vouched 1M-op batch on a fresh replica
    s0 = snap()
    t1 = engine.init(1, device=dev)
    t1.apply_packed(full)
    torch.cuda.synchronize()
    steps_l["bootstrap"] = delta(s0, snap())
    t0 = time.perf_counter()
    closed_form(t1, "bootstrap")
    out["first_visible_values_ms"] = (time.perf_counter() - t0) * 1e3
    st = np.asarray(t1.table().status)[:N_OPS]
    if not np.all(st == merge.APPLIED) or t1.log_length != N_OPS:
        raise RuntimeError("engine bootstrap: some op not applied")
    for k in ("plane_rows2", "prefix_sums", "monotone_gather"):
        if steps_l["bootstrap"][k] < 1:
            raise RuntimeError(f"engine bootstrap never launched {k}")
    log(f"engine bootstrap: {N_OPS} ops applied, closed-form order; "
        f"launches {steps_l['bootstrap']}")

    # 2. bulk anti-entropy: 800k bootstrap, then the 200k rest chunked
    s0 = snap()
    t2 = engine.init(1, device=dev)
    t2.apply_packed(head)
    first_on_card = t2.packed_route(min(DEFAULT_CHUNK_OPS, N_OPS - N_HEAD))
    t2.apply_packed_chunked(rest, DEFAULT_CHUNK_OPS)
    torch.cuda.synchronize()
    steps_l["anti_entropy"] = delta(s0, snap())
    if t2._mirror is None or t2._table is not None:
        raise RuntimeError("engine anti-entropy: the last chunk did not "
                           "take the host mirror")
    closed_form(t2, "anti-entropy")
    if t2.log_length != N_OPS or \
            int(np.sum(t2.last_applied_mask)) != N_OPS - N_HEAD:
        raise RuntimeError("engine anti-entropy: wrong applied count")
    log(f"engine anti-entropy: {N_HEAD} + {N_OPS - N_HEAD} ops in chunks "
        f"of {DEFAULT_CHUNK_OPS} (first chunk on the card: {first_on_card}, "
        f"last through the host mirror), closed-form order")
    del t2

    # 3. interactive deltas on the bootstrapped replica (host mirror),
    # held to a fresh bulk merge of its whole log; the same session on
    # a 4,096-op replica held to the oracle
    steps = session_steps(5, exp[::997])
    s0 = snap()
    host_ms, _ = run_session(t1, steps, Add)
    steps_l["interactive"] = delta(s0, snap())
    if any(steps_l["interactive"].values()):
        raise RuntimeError("engine interactive deltas left the host mirror")
    vals1 = t1.visible_values()
    check = engine.init(1, device=dev)
    check.apply_packed(t1.packed_state())
    if check.visible_values() != vals1:
        raise RuntimeError("engine interactive: host mirror differs from "
                           "the bulk merge of the same log")
    small_arrs = workloads.chain_workload(N_REPLICAS, 4096)
    small = packed_chain(small_arrs, 4096)
    ts_small = engine.init(1, device=dev)
    ts_small.apply_packed(small)
    oracle = CRDTree.init(1).apply(Batch(tuple(packed.unpack(small))))
    _, oracle = run_session(ts_small, session_steps(6, small_arrs["ts"]),
                            Add, oracle)
    if ts_small.visible_values() != oracle.visible_values() or \
            ts_small.timestamp != oracle.timestamp:
        raise RuntimeError("engine interactive: differs from the oracle")
    out["host_delta_p50_ms"] = float(np.median(host_ms))
    log(f"engine interactive: {N_REMOTE} remote + {N_LOCAL} local edits "
        f"on the {N_OPS}-op replica == its bulk merge ({len(vals1)} "
        f"visible); the "
        f"same session on 4,096 ops == the oracle")

    # 4. restores: the older format (no hints) takes the sort+join on
    # the card, once; the vouched file the exhaustive leg
    buf = io.BytesIO()
    t1.checkpoint_packed(buf, compress=False)
    old = strip_hints(buf.getvalue())
    s0 = snap()
    fb0 = merge.fallbacks
    rp = []
    caught = capture_inputs(
        lambda: rp.append(engine.TpuTree.restore_packed(
            io.BytesIO(old), device=dev).visible_values()),
        [(fr, "plane_rows")])
    steps_l["restore_unvouched"] = delta(s0, snap())
    if rp[0] != vals1 or merge.fallbacks - fb0 != 1:
        raise RuntimeError(f"engine unvouched restore: values equal "
                           f"{rp[0] == vals1}, fallbacks "
                           f"{merge.fallbacks - fb0}")
    if steps_l["restore_unvouched"]["plane_rows"] < 1:
        raise RuntimeError("engine unvouched restore never launched "
                           "plane_rows")
    s0 = snap()
    fb0 = merge.fallbacks
    r2 = engine.TpuTree.restore_packed(io.BytesIO(buf.getvalue()),
                                       device=dev)
    if not r2.packed_state().hints_vouched or \
            r2.visible_values() != vals1 or merge.fallbacks != fb0:
        raise RuntimeError("engine vouched restore differs")
    steps_l["restore_vouched"] = delta(s0, snap())
    log(f"engine restores: older format -> sort+join on the card "
        f"(1 fallback, launches {steps_l['restore_unvouched']}); vouched "
        f"-> exhaustive (no fallback); both equal the replica")
    del r2, rp

    # 5. corrupt hints: one swapped ts_rank in a 65,536-op slice
    sl = workloads.chain_workload(N_REPLICAS, N_SLICE)
    r = sl["ts_rank"].copy()
    j = N_SLICE * 5 // 8
    r[5], r[j] = r[j], r[5]
    bad = dict(sl, ts_rank=r)
    fb0 = merge.fallbacks
    got = convert.table_to_numpy(merge.materialize(bad, hints=None, device=dev))
    if merge.fallbacks - fb0 != 1:
        raise RuntimeError("corrupt ts_rank did not fall back")
    want = convert.table_to_numpy(merge.materialize(bad, hints="join", device=dev))
    diff = [f for f in merge.FIELDS if got[f].dtype != want[f].dtype
            or not np.array_equal(got[f], want[f])]
    if diff:
        raise RuntimeError(f"corrupt ts_rank: fallback != join in {diff}")
    torch.cuda.synchronize()
    launches = snap()
    out["launches"] = launches
    out["launches_by_step"] = steps_l
    out["fallbacks"] = merge.fallbacks
    log(f"engine corrupt hints: swapped ts_rank fell back, == join field "
        f"for field; engine launches {launches}")
    for k, v in launches.items():
        if v < 1:
            raise RuntimeError(f"the engine phase never launched {k}")

    # the engine path's new kernel-1 shapes against the twin
    errs = []
    for args in caught.get("plane_rows", []):
        g = calls["plane_rows"](*args)
        w = twins["plane_rows"](*(a.cpu() for a in args))
        torch.cuda.synchronize()
        errs.append(0.0 if torch.equal(g.cpu(), w) else
                    float((g.cpu().double() - w.double()).abs().max()))
    out["plane_rows_engine_shapes"] = [list(a[0].shape)
                                       for a in caught["plane_rows"]]
    out["plane_rows_engine_err"] = max(errs)
    if max(errs) != 0:
        raise RuntimeError("plane_rows disagrees with its twin at the "
                           "engine's shapes")

    # ---- timing (not counted) ------------------------------------------
    def staged_bootstrap():
        t = engine.init(1, device=dev)
        c0 = time.perf_counter()
        cand = t.prepare_packed(full)
        c1 = time.perf_counter()
        table = t._materialize(cand)
        torch.cuda.synchronize()
        c2 = time.perf_counter()
        table.status[0:N_OPS].cpu()
        c3 = time.perf_counter()
        t.finish_packed(full, cand, table)
        c4 = time.perf_counter()
        return t, [(c1 - c0) * 1e3, (c2 - c1) * 1e3, (c3 - c2) * 1e3,
                   (c4 - c3) * 1e3, (c4 - c0) * 1e3]

    parts = []
    for _ in range(5):
        t, ms = staged_bootstrap()
        parts.append(ms)
    parts = np.asarray(parts)
    med = np.median(parts, axis=0)
    out["bootstrap_ms"] = {"concat": med[0], "merge": med[1],
                           "status_read": med[2], "finish": med[3],
                           "total_p50": med[4],
                           "totals": parts[:, 4].tolist()}
    h0 = time.perf_counter()
    host_table = view.to_host(t._table)
    h1 = time.perf_counter()
    HostTree.from_table(host_table, full.values, t._max_depth)
    h2 = time.perf_counter()
    out["first_read_split_ms"] = {"to_host": (h1 - h0) * 1e3,
                                  "from_table": (h2 - h1) * 1e3}
    del t
    d_ms = []
    for _ in range(3):
        t = engine.init(1, device=dev)
        t.apply_packed(head)
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        t.apply_packed_chunked(rest, DEFAULT_CHUNK_OPS)
        torch.cuda.synchronize()
        d_ms.append((time.perf_counter() - c0) * 1e3)
        del t
    out["delta_200k_ms"] = {"p50": float(np.median(d_ms)), "times": d_ms}
    legs = {}
    for name, a, h in (("exhaustive", arrs, "exhaustive"),
                       ("auto_verified", arrs, None),
                       ("join", arrs, "join")):
        merge.host_syncs = 0
        merge.fallbacks = 0
        merge.materialize(a, hints=h, device=dev)
        torch.cuda.synchronize()
        syncs, fbs = merge.host_syncs, merge.fallbacks
        tm = honest.time_with_readback(
            lambda: merge.materialize(a, hints=h, device=dev), repeats=5)
        legs[name] = {"p50_ms": tm["p50_ms"], "times_ms": tm["times_ms"],
                      "host_syncs": syncs, "fallbacks": fbs}
    merge.host_syncs = 0
    merge.fallbacks = 0
    merge.materialize(bad, hints=None, device=dev)
    legs["auto_fallback_65536"] = {"host_syncs": merge.host_syncs,
                                   "fallbacks": merge.fallbacks}
    out["merge_legs"] = legs
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    b = out["bootstrap_ms"]
    log(f"engine bootstrap apply_packed p50 {b['total_p50']:.3f} ms "
        f"(concat {b['concat']:.3f}, merge {b['merge']:.3f}, status read "
        f"{b['status_read']:.3f}, finish {b['finish']:.3f}); first "
        f"visible_values {out['first_visible_values_ms']:.1f} ms (to_host "
        f"{out['first_read_split_ms']['to_host']:.1f}, from_table "
        f"{out['first_read_split_ms']['from_table']:.1f})")
    log(f"engine 200k delta p50 {out['delta_200k_ms']['p50']:.1f} ms; "
        f"one-op host delta p50 {out['host_delta_p50_ms']:.4f} ms; peak "
        f"device memory {out['peak_mem_bytes']} B")
    for name, v in legs.items():
        if "p50_ms" in v:
            log(f"engine merge leg {name} at {N_OPS}: p50 "
                f"{v['p50_ms']:.3f} ms, "
                f"{v['host_syncs']} host syncs, {v['fallbacks']} fallbacks")
        else:
            log(f"engine merge leg {name}: {v['host_syncs']} host syncs, "
                f"{v['fallbacks']} fallbacks")
    record["engine"] = out
    return launches


HOT_OPS = 32768                # the serving default hot-tail budget
N_CRASH = 16384                # the unacknowledged commit the crash kills


def durability_phase(dev, record, calls, twins):
    """Durable replicas on the card at full size: the native wire codec
    round trip; a tiered, WAL-backed ingest of the config-5 head by
    ``apply_wire`` in the serving scheduler's commits; a tiered
    checkpoint with matz; a WAL-only tail with deletes; a crash at
    ``mid-spill``; two recoveries (a full merge on the card, and the
    matz artifact) held to a never-crashed replica field for field and
    byte for byte; and the damage taxonomy.  Raises on any mismatch.
    Returns the kernel launches of the phase."""
    import os
    import shutil
    import warnings
    import numpy as np
    import torch
    from crdt_graph_tpu_torch import engine, kernels, native, wal
    from crdt_graph_tpu_torch.bench import workloads
    from crdt_graph_tpu_torch.codec import json_codec, packed
    from crdt_graph_tpu_torch.core import operation as op_mod
    from crdt_graph_tpu_torch.core.errors import CheckpointError
    from crdt_graph_tpu_torch.ops import fused_resolve as fr, merge, \
        mono_gather as mg, tour_scan as tsc

    if not native.available():
        raise RuntimeError(f"native codec unavailable: {native._build_error}")
    out = {}
    arrs = workloads.chain_workload(N_REPLICAS, N_OPS)
    full = packed_chain(arrs, N_OPS)
    ts_col = arrs["ts"]

    def rows(p, lo, hi):
        return packed.select_rows(p, np.arange(lo, hi))

    # ---- 1. the native codec round trip --------------------------------
    enc, dec = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        wire_full = native.encode_pack(full)
        enc.append((time.perf_counter() - t0) * 1e3)
    for _ in range(3):
        t0 = time.perf_counter()
        back = native.parse_pack(wire_full)
        dec.append((time.perf_counter() - t0) * 1e3)
    cols = ("kind", "ts", "parent_ts", "anchor_ts", "depth", "paths",
            "value_ref", "pos", "parent_pos", "anchor_pos", "target_pos",
            "ts_rank")
    bad = [c for c in cols if not np.array_equal(
        getattr(back, c)[:N_OPS], getattr(full, c)[:N_OPS])]
    if back.num_ops != N_OPS or bad or back.values != full.values:
        raise RuntimeError(f"native round trip differs in {bad}")
    sl = rows(full, 0, N_SLICE)
    if native.encode_pack(sl) != json_codec.dumps(
            op_mod.from_list(packed.unpack(sl))).encode():
        raise RuntimeError("native encoder differs from the Python codec")
    out["native"] = {"wire_bytes": len(wire_full),
                     "encode_ms": enc, "encode_p50_ms": float(np.median(enc)),
                     "parse_ms": dec, "parse_p50_ms": float(np.median(dec))}
    log(f"durability native codec: {N_OPS} ops <-> {len(wire_full)} wire "
        f"bytes; encode p50 {np.median(enc):.1f} ms, parse p50 "
        f"{np.median(dec):.1f} ms; columns equal; == the Python encoder "
        f"on {N_SLICE} ops")
    del back, wire_full

    # ---- commits: the head, and a tail whose deletes follow its adds ---
    dels = packed.pack([op_mod.Delete((int(t),))
                        for t in ts_col[N_HEAD:N_OPS:DEL_EVERY]])
    tail = packed.concat(rows(full, N_HEAD, N_OPS), dels)

    def commits(p):
        return [native.encode_pack(rows(p, s, min(s + DEFAULT_CHUNK_OPS,
                                                  p.num_ops)))
                for s in range(0, p.num_ops, DEFAULT_CHUNK_OPS)]
    head_w, tail_w = commits(rows(full, 0, N_HEAD)), commits(tail)
    crash_w = json_codec.dumps(op_mod.from_list([
        op_mod.Add(99 * 2**32 + c, ((99 * 2**32 + c - 1) if c > 1 else 0,),
                   -c) for c in range(1, N_CRASH + 1)])).encode()
    gone = ts_col[N_HEAD:N_OPS:DEL_EVERY]
    exp = workloads.chain_expected_ts(N_REPLICAS, N_OPS)
    exp = exp[~np.isin(exp, gone)]

    root = ROOT / "build" / "durability"
    shutil.rmtree(root, ignore_errors=True)
    d = root / "replica"
    d.mkdir(parents=True)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    native.reset_calls()
    steps_l = {}

    def snap():
        return dict(kernels.launches)

    def delta(a):
        return {k: kernels.launches[k] - a[k] for k in a}

    # ---- 2. durable ingest on the card ---------------------------------
    s0 = snap()
    tree = engine.init(1, device=dev)
    tree.enable_log_tiering(str(d), hot_ops=HOT_OPS, durable=True,
                            ephemeral=False)
    advanced = []
    tree._log.set_durable_hooks(tree.manifest_meta, advanced.append)
    w = wal.Wal(str(d / "wal.log"))
    apply_ms, wal_ms, trunc_ms = [], [], []
    split = {"parse": [], "tier_reload": [], "spill_fold": []}

    def timed(owner, attr, key):
        """Accumulate the time of ``owner.attr`` calls under ``key`` (a
        split of the commit time; the calls themselves are unchanged)."""
        fn = getattr(owner, attr)

        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                split[key][-1] += (time.perf_counter() - t0) * 1e3
        setattr(owner, attr, run)
        return fn
    parse0 = timed(native, "parse_pack", "parse")
    timed(tree._log, "to_packed", "tier_reload")
    timed(tree._log, "maybe_spill", "spill_fold")

    def commit(payload):
        """One acknowledged commit, as a durable server makes it: apply,
        append the applied rows, fsync, then drop the WAL prefix the
        tiers cover once a manifest advanced."""
        n0 = tree.log_length
        for v in split.values():
            v.append(0.0)
        t0 = time.perf_counter()
        tree.apply_wire(payload)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if tree.log_length > n0:
            w.append(tree.log_view().slice_packed(n0, tree.log_length),
                     tree.log_length)
        w.sync()
        t2 = time.perf_counter()
        if advanced:
            w.truncate_below(tree._log.tiered_extent)
            advanced.clear()
        apply_ms.append((t1 - t0) * 1e3)
        wal_ms.append((t2 - t1) * 1e3)
        trunc_ms.append((time.perf_counter() - t2) * 1e3)

    for payload in head_w:
        commit(payload)
    t0 = time.perf_counter()
    tree.checkpoint_tiered(str(d), write_matz=True)
    ckpt_ms = (time.perf_counter() - t0) * 1e3
    if tree._log.matz_entry is None or tree.log_length != N_HEAD:
        raise RuntimeError("durability: the checkpoint wrote no matz")
    for payload in tail_w:
        commit(payload)
    native.parse_pack = parse0
    steps_l["ingest"] = delta(s0)
    n_commits = len(head_w) + len(tail_w)
    if native.calls["parse_pack"] != n_commits:
        raise RuntimeError(f"durability ingest: {native.calls['parse_pack']}"
                           f" native parses for {n_commits} commits")
    tele = tree._log.telemetry()
    out["ingest"] = {"commits": n_commits, "apply_ms": list(apply_ms),
                     "apply_split_ms": {k: list(v)
                                        for k, v in split.items()},
                     "wal_append_fsync_ms": list(wal_ms),
                     "wal_truncate_ms": list(trunc_ms),
                     "wal_p50_ms": float(np.median(wal_ms)),
                     "checkpoint_tiered_ms": ckpt_ms,
                     "spills": tele["spills"],
                     "compactions": tele["compactions"],
                     "segments": tele["segments"],
                     "tiered_extent": tree._log.tiered_extent,
                     "wal_bytes": w.size_bytes(),
                     "native_parses": native.calls["parse_pack"]}
    log(f"durability ingest: {n_commits} commits by apply_wire (native "
        f"parses {native.calls['parse_pack']}), {tree.log_length} ops; "
        f"apply p50 {np.median(apply_ms):.1f} ms per commit (parse "
        f"{np.median(split['parse']):.1f}, tier reload "
        f"{np.median(split['tier_reload']):.1f}, spill+fold "
        f"{np.median(split['spill_fold']):.1f}); WAL "
        f"append+fsync p50 {np.median(wal_ms):.1f} ms per commit "
        f"(then truncation p50 {np.median(trunc_ms):.1f} ms); "
        f"checkpoint_tiered {ckpt_ms:.1f} ms; {tele['spills']} spills, "
        f"{tele['compactions']} folds, segments {tele['segments']}, tiered "
        f"extent {tree._log.tiered_extent}, WAL {w.size_bytes()} B")

    # ---- 3. crash mid-spill on one more (unacknowledged) commit --------
    s0 = snap()
    os.environ["GRAFT_CRASH_POINT"] = "mid-spill"
    try:
        commit(crash_w)
        raise RuntimeError("durability: the mid-spill crash never fired")
    except wal.CrashPoint:
        pass
    finally:
        del os.environ["GRAFT_CRASH_POINT"]
    w.close()
    del tree
    steps_l["crash"] = delta(s0)

    # the never-crashed replica: the same acknowledged commits, untiered
    ref = engine.init(1, device=dev)
    for payload in head_w + tail_w:
        ref.apply_wire(payload)
    ref_full = ref.packed_state()
    ref_table = {f: np.asarray(getattr(ref.table(), f)) for f in merge.FIELDS}
    ref_vals = ref.visible_values()
    if not np.array_equal(ts_col[np.asarray(ref_vals, np.int64)], exp):
        raise RuntimeError("durability: the never-crashed replica's order "
                           "is wrong")
    for name in ("a", "b"):
        shutil.copytree(d, root / f"recover-{name}")

    # ---- 4. two recoveries on the card ---------------------------------
    legs, ref_dumps = [], {}
    real_materialize = merge.materialize

    def leg_of(arrays, hints=None, **kw):
        legs.append(hints)
        return real_materialize(arrays, hints=hints, **kw)

    def recover(name, use_matz):
        dd = root / f"recover-{name}"
        s1 = snap()
        t0 = time.perf_counter()
        r = engine.TpuTree.restore_tiered(str(dd), use_matz=use_matz,
                                          device=dev)
        t1 = time.perf_counter()
        base = [(c.start, c.length) for c in r._log._bases]
        cold = [(c.start, c.length) for c in r._log._cold]
        extent = r._log.tiered_extent
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            st = wal.Wal(str(dd / "wal.log")).replay_into(r, 1 << 17)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            vals = r.visible_values()
            t3 = time.perf_counter()
        rec = {"restore_tiered_ms": (t1 - t0) * 1e3,
               "replay_ms": (t2 - t1) * 1e3, "first_read_ms": (t3 - t2) * 1e3,
               "replay": st, "restored_extent": extent,
               "matz": dict(r.matz_stats),
               "matz_warnings": [str(x.message) for x in warned
                                 if issubclass(x.category,
                                               engine.MatzWarning)],
               "launches": delta(s1)}
        if vals != ref_vals:
            raise RuntimeError(f"recovery {name}: visible values differ")
        # every table field, the clocks, and the wire at three seams
        tab = r.table()
        diff = [f for f in merge.FIELDS
                if not np.array_equal(np.asarray(getattr(tab, f)),
                                      ref_table[f])]
        if diff or r._replicas != ref._replicas or \
                r.log_length != ref.log_length:
            raise RuntimeError(f"recovery {name}: table differs in {diff}")
        if not base or not cold:
            raise RuntimeError(f"recovery {name}: tiers {base} + {cold}")
        seams = {"inside_base_chunk": base[0][0] + base[0][1] // 2,
                 "base_to_cold_boundary": cold[0][0],
                 "inside_cold_segment": cold[-1][0] + cold[-1][1] // 2,
                 "inside_wal_tail": (extent + N_OPS) // 2}
        if not (extent < seams["inside_wal_tail"] < N_OPS):
            raise RuntimeError(f"recovery {name}: no WAL tail past the "
                               f"tiers (extent {extent})")
        view = r.log_view()
        for seam, row in seams.items():
            since = int(ts_col[row])
            if view.window(since, 4096) != engine.packed_since_window(
                    ref_full, since, 4096):
                raise RuntimeError(f"recovery {name}: window at {seam}")
            if since not in ref_dumps:
                ref_dumps[since] = ref.dumps_since_bytes(since)
            if r.dumps_since_bytes(since) != ref_dumps[since]:
                raise RuntimeError(f"recovery {name}: dumps at {seam}")
        rec["seams"] = seams
        return r, rec

    got = {}
    merge.materialize = leg_of
    try:
        caught = capture_inputs(
            lambda: got.update(a=recover("a", False)),
            [(fr, "plane_rows"), (fr, "plane_rows2"),
             (tsc, "prefix_sums"), (mg, "monotone_gather")])
        out["recover_a"] = got["a"][1]
        out["recover_a"]["legs"] = [h or "auto" for h in legs]
        del legs[:]
        out["recover_b"] = recover("b", True)[1]
        out["recover_b"]["legs"] = [h or "auto" for h in legs]
    finally:
        merge.materialize = real_materialize
    del got
    ra_l = out["recover_a"]["launches"]
    if ra_l["prefix_sums"] < 1 or ra_l["monotone_gather"] < 1 or \
            ra_l["plane_rows"] + ra_l["plane_rows2"] < 1:
        raise RuntimeError(f"recovery a launched {ra_l}")
    used = out["recover_b"]["matz"]["loads"] == 1
    for name, how in (("a", "full merge"), ("b", "matz")):
        rc = out[f"recover_{name}"]
        log(f"durability recovery {name} ({how}): restore_tiered "
            f"{rc['restore_tiered_ms']:.1f} ms, WAL "
            f"replay {rc['replay_ms']:.1f} ms ({rc['replay']['records']} "
            f"records, {rc['replay']['applied']} applied), first read "
            f"{rc['first_read_ms']:.1f} ms; legs {rc['legs']}; matz "
            f"{rc['matz']}; launches {rc['launches']}; == the never-crashed "
            f"replica (values, table, clocks, windows and dumps at "
            f"{sorted(rc['seams'])})")
    out["matz_used"] = used
    log(f"durability recovery b: matz artifact "
        f"{'used' if used else 'fell back (MatzWarning)'}")

    # every kernel the phase launched, against its twin
    errs = {}
    for kname, cases in caught.items():
        e = 0.0
        for args in cases:
            got = calls[kname](*args)
            want = twins[kname](*(a.cpu() if hasattr(a, "cpu") else a
                                  for a in args))
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            e = max(e, max_abs_err(got, want))
        errs[kname] = e
    out["twin_err"] = errs
    out["twin_shapes"] = {k: [list(a.shape) for a in v[0]
                              if hasattr(a, "shape")]
                          for k, v in caught.items()}
    if any(errs.values()):
        raise RuntimeError(f"a kernel disagrees with its twin in the "
                           f"durability phase: {errs}")
    del caught

    # ---- 5. damage -------------------------------------------------------
    dd = root / "recover-a"
    r = engine.TpuTree.restore_tiered(str(dd), use_matz=False, device=dev)
    victim = r._log._cold[0] if r._log._cold else r._log._bases[0]
    flip_zip_data(victim.path)
    rep = r._log.scrub()
    if rep["corrupt"] != 1 or r._log.telemetry()["quarantined"] != 1:
        raise RuntimeError(f"durability: scrub did not quarantine {rep}")
    (dd / "manifest.json").write_text('{"length": "broken"')
    try:
        engine.TpuTree.restore_tiered(str(dd), device=dev)
        raise RuntimeError("durability: a broken manifest restored")
    except CheckpointError:
        pass
    small = root / "wal-damage"
    small.mkdir()
    ws = wal.Wal(str(small / "wal.log"))
    for k in range(3):
        ws.append(rows(full, 4096 * k, 4096 * (k + 1)), 4096 * (k + 1))
    ws.sync()
    ws.close()
    data = (small / "wal.log").read_bytes()
    first = wal.scan(str(small / "wal.log"))[0][0][0]
    midlog = bytearray(data)
    midlog[first + 64] ^= 0xFF
    (small / "mid.log").write_bytes(bytes(midlog))
    try:
        wal.Wal(str(small / "mid.log")).replay_into(
            engine.init(1, device=dev))
        raise RuntimeError("durability: a mid-log flip replayed")
    except wal.WalError:
        pass
    (small / "torn.log").write_bytes(data[:-5])
    rt = engine.init(1, device=dev)
    st = wal.Wal(str(small / "torn.log")).replay_into(rt)
    if st["torn_dropped"] != 1 or rt.log_length != 8192:
        raise RuntimeError(f"durability: torn tail not tolerated {st}")
    log("durability damage: flipped cold segment quarantined by scrub; "
        "broken manifest -> CheckpointError; mid-log WAL flip -> WalError; "
        "torn final record tolerated and counted")

    torch.cuda.synchronize()
    launches = snap()
    out["launches"] = launches
    out["launches_by_step"] = steps_l
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(f"durability launches {launches}; peak device memory "
        f"{out['peak_mem_bytes']} B")
    shutil.rmtree(root, ignore_errors=True)
    record["durability"] = out
    return launches


def flip_zip_data(path) -> None:
    """One bit-rot event inside the data of an npz's largest member (a
    flip in a zip local header is benign and legitimately not flagged)."""
    import struct
    import zipfile
    with zipfile.ZipFile(path) as z:
        info = max(z.infolist(), key=lambda i: i.compress_size)
    with open(path, "r+b") as f:
        f.seek(info.header_offset + 26)
        fn_len, extra_len = struct.unpack("<HH", f.read(4))
        f.seek(info.header_offset + 30 + fn_len + extra_len
               + info.compress_size // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from crdt_graph_tpu_torch import convert, kernels, native
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

    # ---- 2. build: the CUDA kernels and, beside them, the native codec --
    t0 = time.perf_counter()
    cxx = threading.Thread(target=native.load)
    cxx.start()
    build.load()
    record["phases"]["build_s"] = time.perf_counter() - t0
    cxx.join()
    record["phases"]["build_native_s"] = time.perf_counter() - t0
    if not native.available():
        raise RuntimeError(f"native codec did not build: "
                           f"{native._build_error}")
    log(f"build: {record['phases']['build_s']:.2f} s "
        f"({build.BUILD_ROOT}); native codec "
        f"{record['phases']['build_native_s']:.2f} s ({native.so_path()})")
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
    def vouched(arrs):
        """The main path's merge: a vouched batch in the exhaustive mode
        the engine dispatches for its own ingest."""
        return merge.materialize(arrs, hints="exhaustive", device=dev)

    caught = capture_inputs(lambda: (vouched(adds), vouched(dels)),
                            wrappers)
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
    t_adds = vouched(adds)
    torch.cuda.synchronize()
    launches_adds = dict(kernels.launches)
    syncs_adds = merge.host_syncs
    t_dels = vouched(dels)
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
        on_card = convert.table_to_numpy(vouched(arrs))
        t_card = time.perf_counter() - t0
        on_cpu = convert.table_to_numpy(merge.materialize(
            arrs, hints="exhaustive", device="cpu"))
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

    # ---- 5. the replica engine (its own counted drive) ----------------
    engine_launches = engine_phase(dev, record, calls, twins)
    record["kernels"]["plane_rows"]["max_abs_err"] = max(
        record["kernels"]["plane_rows"]["max_abs_err"],
        record["engine"]["plane_rows_engine_err"])

    # ---- 6. durable replicas (their own counted drive) ----------------
    dur_launches = durability_phase(dev, record, calls, twins)
    for kname, e in record["durability"]["twin_err"].items():
        record["kernels"][kname]["max_abs_err"] = max(
            record["kernels"][kname]["max_abs_err"], e)

    # ---- 7. timing ------------------------------------------------------
    t_np = honest.time_with_readback(lambda: vouched(adds), repeats=7)
    def h2d():
        cols = convert.ops_from_numpy(
            {k: adds[k] for k in merge.MERGE_COLS if k in adds}, dev)
        torch.cuda.synchronize()
        return cols
    h2d()
    t0 = time.perf_counter()
    dev_cols = h2d()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    t_del = honest.time_with_readback(lambda: vouched(dels), repeats=7)
    torch.cuda.reset_peak_memory_stats()
    del dev_cols
    vouched(adds)
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
                     "replaces": replaces,
                     "launches": launches[kname] + engine_launches[kname]
                     + dur_launches[kname],
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
