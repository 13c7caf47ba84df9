#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # one card
    python3 chip_smoke.py --route-on   # GRAFT_OPSAXIS=1 (several cards)

Builds the port's CUDA kernels from ``crdt_graph_tpu_torch/csrc`` with
``nvcc`` (sm_90a) and, beside them, its native wire codec with ``g++``
(``crdt_graph_tpu_torch/native``), holds each kernel against its plain
PyTorch twin at the merge's real shapes (exact equality: integer data;
kernel 1 also at every width C = 1..21 on 16-byte-aligned planes and on
views off that boundary, at T = 0, 1 and ragged, with extreme indices),
and drives seven paths (five here, the fleet and the benches below),
each with the launch counts set to 0 just before it and read just
after:

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
- the ops-axis sharded merge (``crdt_graph_tpu_torch.parallel.opsaxis``)
  at full width: config 5 in 2, 4 and 8 logical shards on the card, the
  with-deletes batch and a halo-straddling deep-paths batch in 8 (and,
  with two or more cards, config 5 with its shards on distinct cards,
  timed beside the single-device merge), each equal field for field to
  the single-device merge, every kernel call of them held to its twin;
  kernel 5, the ring carry exchange, also at edge cases;
- durable replicas at full size: the native codec round trip of the 1M
  ops; an 800k-op ingest by ``apply_wire`` into a tiered replica with a
  WAL, committed, appended and fsynced in the scheduler's chunks; a
  ``checkpoint_tiered`` with the matz artifact; a WAL-only 200k-op tail
  with deletes; a crash at ``mid-spill``; two recoveries
  (``restore_tiered`` + ``Wal.replay_into``: a full merge on the card,
  then from the matz artifact) held to a never-crashed replica field for
  field and byte for byte; the damage taxonomy (scrub quarantine, a
  broken manifest, a mid-log WAL flip, a torn final record);
- the wire service (``crdt_graph_tpu_torch.service.make_server`` on the
  card, durable, ``GRAFT_WAL_SYNC=commit``) hosting 8 documents:
  document 0 bootstrapped by one ``POST`` of config 5 as wire JSON,
  documents 1-7 by one staged round whose same-bucket merges group into
  one batched merge (every kernel call of it held to its twin), then 16
  writer sessions of 8 12-leaf deltas while 8 readers read; every acked
  write reads back before and after a restart, each document's
  ``/ops?since=0`` replays on a CPU replica to the served values.

Right after the merge, the trace audit runs (its own counted path, the
``audit`` phase): ``utils.chainaudit`` counts config 5's and the
deletes batch's memory passes, kernel calls and host syncs by stage at
full size on the card; at 65,536 ops the card's rows equal the CPU's;
a ``torch.profiler`` trace of the same merges holds one CUDA kernel of
each hand kernel's name per counted kernel call; the audited merge is
timed against the plain one; ``opsaxis.audit_opsaxis`` runs config 5 in
8 logical shards (kernel 5 the carry exchange); and a served document
with ``GRAFT_OBS_AUDIT_EVERY=1`` takes one 65,536-op commit whose flight
record must carry an ``ok`` audit of its own merge.  Its ``audit:``
line carries the counts by stage and the audit's cost.

Then the docs-axis batched merge runs (its own counted path, the
``mesh`` phase): ``parallel.mesh.batched_materialize`` merges B = 1, 4
and 16 documents of 65,536 ops as ONE merge over a leading document
axis, timed beside the same documents merged one by one; at B = 16 both
legs launch each kernel's batched form as often as one single merge
does, every call equals its batched twin, every slice its single merge;
the batched kernels also meet per-document traps (wild indices, hops,
wrapping lanes), and the multi-device layer runs (its own counted
path, the ``multidevice`` phase) on 8 logical devices (the one card 8 times, or the visible cards
in turn, logged): ``parallel.shard.shard_materialize`` of config 5 in
both hint modes, of the deletes batch and of a hostile-hints copy that
must fall back, and ``parallel.mesh.sharded_materialize`` of config 5,
each equal field for field to the single-device merge; a 2-D mesh
(docs 4 × ops 2) over four 1M-op documents; ``dryrun_multichip(8)``;
``scripts.bench_docs_axis.run()`` at 8 × 1M; and two processes of
``torch.distributed`` (``chip_smoke.py --multidevice-child``: ``gloo``
on one card, ``nccl`` with a card each) merging 4 of the 8 documents
each, whose fingerprints must agree.  Every kernel call is held to its
twin, the children's too; the three single-merge paths are timed in
turns with their collective bytes (its ``multidevice:`` line).  Then the
fleet runs (a sixth counted path): one merge worker on the card
(``crdt_graph_tpu_torch.mergetier``, real HTTP, registered in a
``FileKV`` pool) and three ``FleetServer`` front-ends
(``crdt_graph_tpu_torch.cluster``, durable engines on the card).  16
documents of 65,536 ops in one staged round and config 5 as one
``POST`` ship to the worker, which merges each linger window as one
batched merge (every kernel call held to its twin, no fallback); 24
writer sessions write through non-primary nodes (forwarded) and
anti-entropy converges the three replicas; the worker then crashes and
one more round falls back, one ``transport`` fallback a document, to
merges on the front-ends' card.  Every replica equals a ``TpuTree`` on
the card fed the same ops and serves every acked write.

Last, the benches run on the card (a seventh counted path,
the ``bench`` phase): ``bench.runner`` over configs 1-8 at full size
and the config-5 headline, the editor's per-op latency and bulk deltas
(``bench.incremental`` on ``models.TextBuffer``), the in-process
serving bench, and the oracle-checked load generator against a durable
server (64 sessions, 8 watchers, a 262,144-op giant; the three-node
fleet's load generator runs in the headline phase); every row is
order-exact with its timing audit ok, the load run has zero violations,
and every kernel call of the benches is held to its twin.

Then the serving tier's host-side durability and cache run on the card
(the eighth and ninth counted paths, one launch column): the
``walshared`` phase serves 64 documents from one durable engine on ONE
shared group-commit WAL stream (config 5 as one ``POST``, 63 documents
in one staged round, 64 writers while 8 readers read), reads fsyncs a
round and covered documents a fsync from ``/metrics/prom``, kills the
server at ``post-fsync-pre-publish`` and recovers every document on the
card with its ``state_fingerprint``, then runs the same load with a WAL
a document for the same numbers; the ``shmcache`` phase serves config 5
from this process and a child ``python -m crdt_graph_tpu_torch.service``
in one shared-memory namespace: identical bodies, one encode on the
host, no segment left.

Then the headline entry points run (the tenth counted path, the
``headline`` phase): every module of ``crdt_graph_tpu_torch.scripts``
through its own ``run(...)`` with no ``device=``, at the reference's
widths (1M-op documents, the 140,000-op serve giant, 12-leaf deltas,
1,000 watchers, 64-document shapes) and a cut depth, every kernel call
held to its twin; zero violations, equal fingerprints, no merge-tier
fallback, readpath's and broadcast's two legs byte-identical and every
acked write read back fail the phase, and the references' speed gates
are reported with their verdicts on its ``headline:`` line.

The ``walshared`` and ``headline`` phases run in a child process
(``chip_smoke.py --side-phases DIR``, started once the kernels are
built) beside this process's phases, both on the one card: the phases
are bound by their hosts' Python, not by the card, and run in series
they outlast the script's time.  Each process counts its own launches
(each phase from zero) and holds its own kernel calls to their twins;
the child's lines, record and launch counts join this process's once
it ends, before the kernels are timed alone on the card.  Phase seconds
of the two processes overlap and are not comparable with a serial run.

With ``--route-on`` the engine's and the durable replicas' bulk merges
of 2^18 rows or more take the ops-axis route (off by default) where the
host has two or more cards, and those phases hold kernel 5 to its twin
as well.  Then it times the merge, the engine's stages and the merge's
three hint legs, and each kernel, its twin and its library call by three
clocks (``crdt_graph_tpu_torch/bench/kerneltime.py``): device time from
the profiler, CUDA events, and host time a wrapper call; the kernel
also with the L2 flushed before each call, the time its bound share is
taken on; beside each bound, the launch floor (a one-element add's
time on that same cold clock, in the same call) and the bound that
includes it, with its share of the kernel's cold time.  Kernel
1 is also timed at two more widths (its ``widths``):
C = 3 and C = 17, captured from unvouched 1M-op merges.  Exits
non-zero, printing no result, without a CUDA device or without the
package beside it.  The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels with their launches (all paths), errors and times,
the batched forms (``*_batched``) as rows of their own, timed on the
B = 16 batch's arguments;
the ``audit:``, ``serve:``, ``mesh:``, ``multidevice:``, ``fleet:``, ``bench:``,
``walshared:``, ``shmcache:`` and ``headline:`` lines carry the serving,
batching, fleet, benchmark, WAL, shared-cache and headline numbers with
the card's name and power limit.
The full record also goes to ``build/chip_smoke.json``
(``build/chip_smoke_route_on.json`` with ``--route-on``).
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
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
    "ring_exclusive": ("crdt_graph_tpu_torch/csrc/ring_carry.cu",
                       "crdt_graph_tpu/ops/tour_scan.py:240"),
}
# the kernels of the single-device merge (kernel 5 runs only in the
# ops-axis sharded merge)
MERGE_KERNELS = ("plane_rows", "plane_rows2", "prefix_sums",
                 "monotone_gather")
# their batched forms (a leading document axis, one launch a batch): the
# docs-axis batched merge's kernels, built from the same sources
BATCHED = {k + "_batched": KERNELS[k] for k in MERGE_KERNELS}
# the batched forms the default (join-leg) batched merge of documents
# without deletes launches, and how often a batch
BATCHED_JOIN = {"plane_rows_batched": 2, "prefix_sums_batched": 1,
                "monotone_gather_batched": 1}


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_err(got, want) -> float:
    """Largest |got - want| over the outputs (float64; 0 iff equal)."""
    import torch
    if len(got) != len(want):
        return float("inf")
    err = 0.0
    for g, w in zip(got, want):
        if not torch.equal(g.cpu(), w.cpu()):
            err = max(err, float((g.cpu().double() -
                                  w.cpu().double()).abs().max()))
    return err


def _copy(a):
    """A copy of a wrapper's argument or result (tensors cloned where
    they lie, lists and tuples element by element)."""
    if isinstance(a, (list, tuple)):
        return type(a)(_copy(x) for x in a)
    return a.clone() if hasattr(a, "clone") else a


def _cpu(a):
    if isinstance(a, (list, tuple)):
        return type(a)(_cpu(x) for x in a)
    return a.cpu() if hasattr(a, "cpu") else a


def _outputs(x):
    return tuple(x) if isinstance(x, (list, tuple)) else (x,)


# every kernel wrapper of the port: (module name, attribute)
WRAPPERS = (("fused_resolve", "plane_rows"), ("fused_resolve", "plane_rows2"),
            ("tour_scan", "prefix_sums"), ("mono_gather", "monotone_gather"),
            ("tour_scan", "ring_exclusive"),
            ("fused_resolve", "plane_rows_batched"),
            ("fused_resolve", "plane_rows2_batched"),
            ("tour_scan", "prefix_sums_batched"),
            ("mono_gather", "monotone_gather_batched"))


def wrapper_modules(names=None):
    """[(module, attribute)] of the kernel wrappers named (all nine by
    default), for :func:`capture_inputs`."""
    import importlib
    return [(importlib.import_module(f"crdt_graph_tpu_torch.ops.{m}"), a)
            for m, a in WRAPPERS if names is None or a in names]


def capture_inputs(fn, modules):
    """Run ``fn`` with every kernel wrapper of ``modules`` recording a
    copy of its arguments and of what it returned; return
    {name: [(args, out), ...]}."""
    seen = {}
    saved = []
    for mod, name in modules:
        orig = getattr(mod, name)

        def rec(*args, _orig=orig, _name=name):
            out = _orig(*args)
            seen.setdefault(_name, []).append((_copy(args), _copy(out)))
            return out
        saved.append((mod, name, orig))
        setattr(mod, name, rec)
    try:
        fn()
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    return seen


def twin_errors(caught, twins):
    """Each recorded call's output (what the kernel returned on the path)
    held against its twin on CPU copies of the same inputs; launches
    nothing.  {name: max_abs_err over the calls}."""
    import torch
    torch.cuda.synchronize()
    errs = {}
    for kname, cases in caught.items():
        errs[kname] = max(max_abs_err(_outputs(out),
                                      _outputs(twins[kname](*_cpu(args))))
                          for args, out in cases)
    return errs


def fold_errors(record, errs):
    """Raise each kernel's recorded max_abs_err to ``errs``'."""
    for kname, e in errs.items():
        rec = record["kernels"].setdefault(kname, {"max_abs_err": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], e)

def batched_edge_cases(kname, args, rng, dev):
    """The batched kernels' traps at the mesh phase's shapes, from one
    recorded call's arguments: every document's indices wild (negative,
    past R, the int32 extremes), each document's a different draw so a
    neighbour's rows would show; kernel 2's hop column wild and negative;
    kernel 3's lanes at the int32 extremes, so a carry across a document
    boundary would wrap into the next; B = 1 and B = 3 with a ragged
    last block; a kernel-1 plane of odd C (the one-column access)."""
    import numpy as np
    import torch

    def ints(lo, hi, shape, dtype=np.int32):
        return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64)
                                .astype(dtype)).to(dev)

    out = [args]
    if kname in ("plane_rows_batched", "plane_rows2_batched"):
        plane, idx = args[0], args[1]
        b, r, c = plane.shape
        t = idx.shape[1]
        wild = ints(-2 * r, 2 * r, (b, t))
        wild[:, :6] = torch.tensor([-1, -r, -r - 5, r, 2**31 - 1, -2**31],
                                   dtype=torch.int32)
        out.append((plane, wild) + tuple(args[2:]))
        if kname == "plane_rows2_batched":
            far = plane.clone()
            far[:, :, args[2]] = ints(-r // 4, r + 7, (b, r), np.int64)
            out.append((far, wild, args[2]))
        ragged = (t // 256) * 256 - 1
        out.append((plane[:1].contiguous(), idx[:1, :ragged].contiguous())
                   + tuple(args[2:]))
        out.append((plane[:3].contiguous(), wild[:3, :ragged].contiguous())
                   + tuple(args[2:]))
        if kname == "plane_rows_batched":
            odd = ints(-2**31, 2**31 - 1, (3, 4099, 3), np.int64)
            out.append((odd, ints(-9000, 9000, (3, 5001))))
        return out
    if kname == "prefix_sums_batched":
        bnd, w = args
        b, t = bnd.shape
        kw, m = w.shape[1:]
        out.append((ints(-2**31, 2**31 - 1, (b, t)),
                    ints(-2**31, 2**31 - 1, (b, kw, m))))
        out.append((ints(0, 2, (3, t - 3)), ints(-5, 9, (3, 2, m + 1))))
        out.append((ints(0, 2, (1, 4097)),
                    torch.zeros((1, 0, 4097), dtype=torch.int32,
                                device=dev)))
        return out
    vals, rid = args
    b, v, r = vals.shape
    t = rid.shape[1]
    bad = rid.clone()
    bad[:, :4] = torch.tensor([-1, -3, r, 2**31 - 1], dtype=torch.int32)
    out.append((ints(-2**31, 2**31 - 1, (b, v, r)), bad))
    out.append((vals[:3].contiguous(), bad[:3, :t - 5].contiguous()))
    out.append((ints(-9, 9, (2, 7, r)), rid[:2].contiguous()))
    return out


N_AUDIT = 65_536               # the audit's card == CPU size (the sampler's floor)
AUDIT_SHARDS = 8               # the ops-axis audit's logical shards
# the name each hand kernel's CUDA function carries in a profiler trace
KERNEL_EVENTS = {"plane_rows": "plane_rows_kernel",
                 "plane_rows2": "plane_rows2_kernel",
                 "prefix_sums": "scan_lookback",
                 "monotone_gather": "mono_gather_kernel",
                 "ring_exclusive": "ring_exclusive_kernel"}


def profiled_counts(fn):
    """Run ``fn`` once under ``torch.profiler``: the CUDA kernel events
    named after each hand kernel, and the device-to-host copies."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # the card's activity only, as kerneltime.device_ms's sessions:
    # kernels and copies are device events
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    names = [ev.name for ev in prof.events()
             if getattr(ev, "device_type", None) == cuda]
    kern = {k: sum(1 for n in names if ev in n)
            for k, ev in KERNEL_EVENTS.items()}
    return ({k: n for k, n in kern.items() if n},
            sum(1 for n in names if "Memcpy DtoH" in n), len(names))


def profiled_audit():
    """The main path's two 1M merges (config 5 and its deletes batch,
    columns already on the card) run once each under ``torch.profiler``
    in a child process (``chip_smoke.py --profiled-audit``): its CUDA
    kernel events by hand kernel, device-to-host copies and device
    events, by batch.  A child, because in one process the profiler
    records no device events in sessions that start more than about a
    minute after its first session, and the kernels' timing at the end
    of this run needs its own."""
    import subprocess
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--profiled-audit"], capture_output=True,
                       text=True, timeout=600)
    if r.returncode:
        raise RuntimeError(f"profiled audit child exited {r.returncode}: "
                           f"{r.stderr[-2000:]}")
    return {k: tuple(v) for k, v in
            json.loads(r.stdout.strip().splitlines()[-1]).items()}


def profiled_audit_child() -> int:
    """``--profiled-audit``: the child side of :func:`profiled_audit`;
    prints one JSON object."""
    import torch
    sys.path.insert(0, str(ROOT))
    from crdt_graph_tpu_torch import convert
    from crdt_graph_tpu_torch.bench import workloads
    from crdt_graph_tpu_torch.kernels import build
    from crdt_graph_tpu_torch.ops import merge
    dev = torch.device(DEVICE)
    build.load()
    out = {}
    for key, arrs, nd in (
            ("config5", workloads.chain_workload(N_REPLICAS, N_OPS), True),
            ("config5_deletes", workloads.chain_with_deletes(
                N_OPS, DEL_EVERY, N_REPLICAS), False)):
        cols = convert.ops_from_numpy(arrs, dev)
        merge._materialize(cols, "exhaustive", dev, nd)
        out[key] = profiled_counts(
            lambda: merge._materialize(cols, "exhaustive", dev, nd))
    print(json.dumps(out), flush=True)
    return 0


def flight_audits(recorders, tag):
    """The sampled chain audits of a phase's flight recorders (sampling
    is on by default, every 64th commit at or above 65,536 ops): how
    many records carry one, the recorders' audit failures, and each
    sample's ``audit_sample`` stage (ms) and fast path.  Raises on an
    audit failure or a failed sample."""
    recs = [r for f in recorders for r in f.records() if r.audit is not None]
    failures = sum(f.stats()["audit_failures"] for f in recorders)
    bad = [r.audit for r in recs
           if "sample_error" in r.audit or not r.audit.get("ok")]
    if failures or bad:
        raise RuntimeError(f"{tag}: {failures} sampled chain audits over "
                           f"budget; {bad[:2]}")
    return {"sampled": len(recs), "audit_failures": failures,
            "audit_sample_ms": [r.stages_ms.get("audit_sample")
                                for r in recs],
            "fast_path": [r.audit["fast_path"] for r in recs],
            "outer_syncs": [r.audit["outer_syncs"] for r in recs],
            "deletes": [r.audit["deletes"] for r in recs]}


def audit_phase(dev, record, adds, dels, card):
    """The trace audit (``utils.chainaudit``) on the card: config 5 and
    its deletes batch audited at full size; the same columns at
    ``N_AUDIT`` ops audited on the card and on the CPU, every count
    equal; the full-size merges run once more under ``torch.profiler``
    (in a child process, :func:`profiled_audit`), whose kernel events
    named after each hand kernel must equal the audit's
    ``kernel_calls`` (device-to-host copies beside ``host_syncs``
    are recorded); a merge's wall time with the audit against without;
    ``opsaxis.audit_opsaxis`` at ``AUDIT_SHARDS`` logical shards (kernel
    5's calls, its per-shard width within budget); and, with
    ``GRAFT_OBS_AUDIT_EVERY=1``, one served document whose ``N_AUDIT``-op
    commit's flight record must carry an ``ok`` audit and one with
    deletes whose two sampled commits (the deletes batch, then adds
    merged with its log) must too.  Every audit must be within its
    budgets.  Returns the phase's kernel launches."""
    import os

    import torch

    from crdt_graph_tpu_torch import convert, kernels
    from crdt_graph_tpu_torch.bench import honest, workloads
    from crdt_graph_tpu_torch.codec import json_codec, packed as packed_mod
    from crdt_graph_tpu_torch.core.operation import Add, Batch
    from crdt_graph_tpu_torch.obs import flight as flight_mod
    from crdt_graph_tpu_torch.ops import merge
    from crdt_graph_tpu_torch.parallel import opsaxis
    from crdt_graph_tpu_torch.serve import ServingEngine
    from crdt_graph_tpu_torch.utils import chainaudit

    t_phase = time.perf_counter()
    out = {"card": card}
    kernels.reset_launches()
    small = {"config5": (workloads.chain_workload(N_REPLICAS, N_AUDIT), True),
             "config5_deletes": (workloads.chain_with_deletes(
                 N_AUDIT, DEL_EVERY, N_REPLICAS), False)}
    prof = profiled_audit()
    for key, (arrs, nd) in (("config5", (adds, True)),
                            ("config5_deletes", (dels, False))):
        a = chainaudit.audit_materialize(arrs, "exhaustive", nd, dev)
        rec = {**a.summary(), "by_stage": a.by_stage()}
        if not rec["ok"]:
            raise RuntimeError(f"audit {key}: over its budgets: "
                               f"{json.dumps(a.summary())}")
        # the same merge under the profiler (in a child process: see
        # profiled_audit), its kernel events against kernel_calls
        kern, d2h, events = prof[key]
        rec["profiler"] = {"kernel_events": kern, "d2h_copies": d2h,
                           "device_events": events}
        if kern != a.kernel_calls:
            raise RuntimeError(f"audit {key}: profiler kernel events "
                               f"{kern} != kernel_calls {a.kernel_calls}")
        cols = convert.ops_from_numpy(arrs, dev)
        # the audit's own cost: the merge with the mode against without
        plain = honest.time_with_readback(
            lambda: merge._materialize(cols, "exhaustive", dev, nd),
            repeats=5)["p50_ms"]
        def audited_merge():
            with chainaudit.Audit():
                return merge._materialize(cols, "exhaustive", dev, nd)
        audited = honest.time_with_readback(audited_merge,
                                            repeats=5)["p50_ms"]
        rec["merge_ms"], rec["audited_merge_ms"] = plain, audited
        del cols
        # card == CPU at N_AUDIT ops
        sm, snd = small[key]
        on = chainaudit.audit_materialize(sm, "exhaustive", snd, dev)
        off = chainaudit.audit_materialize(sm, "exhaustive", snd, "cpu")
        if on.rows != off.rows:
            i = next((i for i, (x, y) in enumerate(zip(on.rows, off.rows))
                      if x != y), min(len(on.rows), len(off.rows)))
            raise RuntimeError(
                f"audit {key} at {N_AUDIT}: card rows differ from CPU rows "
                f"at row {i}: {on.rows[i:i + 3]} vs {off.rows[i:i + 3]} "
                f"({len(on.rows)} vs {len(off.rows)} rows)")
        if not on.summary()["ok"]:
            raise RuntimeError(f"audit {key} at {N_AUDIT}: over its "
                               f"budgets: {json.dumps(on.summary())}")
        rec[f"at_{N_AUDIT}"] = {**on.summary(), "by_stage": on.by_stage(),
                                "card_equals_cpu": True}
        out[key] = rec
        log(f"audit {key} ({arrs['kind'].shape[0]} ops): "
            f"{json.dumps(a.summary())}; by stage {json.dumps(a.by_stage())};"
            f" profiler kernel events {kern}, device-to-host copies {d2h} "
            f"(audit host_syncs {a.host_syncs}); at {N_AUDIT} ops card == "
            f"cpu: {json.dumps(on.summary())}")
    sh = opsaxis.audit_opsaxis(adds, k=AUDIT_SHARDS, device=dev)
    out["opsaxis"] = sh
    if not sh["ok"] or sh["collective_count"] < 1:
        raise RuntimeError(f"ops-axis audit: {sh}")
    # the flight sampler on a served document
    flight_dir = ROOT / "build" / "audit_flight"
    saved = os.environ.get("GRAFT_OBS_AUDIT_EVERY")
    os.environ["GRAFT_OBS_AUDIT_EVERY"] = "1"
    try:
        rec = flight_mod.FlightRecorder(dump_dir=str(flight_dir))
    finally:
        if saved is None:
            del os.environ["GRAFT_OBS_AUDIT_EVERY"]
        else:
            os.environ["GRAFT_OBS_AUDIT_EVERY"] = saved
    eng = ServingEngine(flight=rec)
    # a0: one config-5 commit; d0, a document with deletes: the deletes
    # batch, then a wire batch of adds merged with its whole log (both
    # run the merge's delete stage)
    darrs = small["config5_deletes"][0]
    n_del = darrs["kind"].shape[0]
    last = int(darrs["ts"][N_AUDIT - 1])
    adds_on = [Add(200 * 2**32 + c, (last if c == 1 else
                                     200 * 2**32 + c - 1,), f"r{c}")
               for c in range(1, N_AUDIT + 1)]
    commits = [("a0", packed_mod.packed_since_bytes(
                    packed_chain(small["config5"][0], N_AUDIT), 0)),
               ("d0", packed_mod.packed_since_bytes(
                    packed_chain(darrs, n_del), 0)),
               ("d0", json_codec.dumps(Batch(tuple(adds_on))))]
    try:
        for doc, wire in commits:
            accepted, _ = eng.submit(doc, wire)
            if not accepted or not eng.flush(120):
                raise RuntimeError(f"the sampled commit on {doc} did not "
                                   "land")
        n_vis = len(eng.get("d0").snapshot_view().visible_values())
        got = {d: [r for r in rec.records() if r.doc_id == d]
               for d in ("a0", "d0")}
        fstats = rec.stats()
    finally:
        eng.close()
    if n_vis != 2 * N_AUDIT - N_AUDIT // DEL_EVERY:
        raise RuntimeError(f"d0 holds {n_vis} visible values")
    sampled = got["a0"][-1].audit if got["a0"] else None
    sampled_del = [r.audit for r in got["d0"]]
    out["flight"] = {"audit": sampled,
                     "stages_ms": got["a0"][-1].stages_ms if got["a0"]
                     else None,
                     "deletes_doc": sampled_del,
                     "deletes_doc_stages_ms": [r.stages_ms
                                               for r in got["d0"]],
                     "audit_failures": fstats["audit_failures"]}
    if not sampled or "sample_error" in sampled or not sampled.get("ok"):
        raise RuntimeError(f"flight sampler: {sampled}")
    if len(sampled_del) != 2 or fstats["audit_failures"] or any(
            not a or "sample_error" in a or not a.get("ok")
            or not a.get("deletes") for a in sampled_del):
        raise RuntimeError(f"flight sampler, document with deletes: "
                           f"{sampled_del} ({fstats['audit_failures']} "
                           f"audit failures)")
    launches = dict(kernels.launches)
    for k in KERNELS:
        if launches[k] < 1:
            raise RuntimeError(f"the audit phase never launched {k}")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    record["audit"] = out
    c5 = out["config5"]
    log("audit: " + json.dumps({
        "card": card,
        "config5": {k: c5[k] for k in ("device_ops", "fast_path",
                                       "host_syncs", "hidden_syncs",
                                       "kernel_calls", "loop_ops")},
        "config5_by_stage": c5["by_stage"],
        "config5_deletes": {k: out["config5_deletes"][k] for k in (
            "device_ops", "fast_path", "host_syncs", "hidden_syncs",
            "kernel_calls", "loop_ops")},
        "config5_deletes_by_stage": out["config5_deletes"]["by_stage"],
        "profiler_d2h": {k: out[k]["profiler"]["d2h_copies"]
                         for k in ("config5", "config5_deletes")},
        "merge_ms": {k: [out[k]["merge_ms"], out[k]["audited_merge_ms"]]
                     for k in ("config5", "config5_deletes")},
        "opsaxis": sh, "flight_audit": sampled,
        "flight_audit_deletes_doc": [
            {k: a[k] for k in ("fast_path", "budget", "ok", "legs",
                               "deletes")} for a in sampled_del],
        "phase_s": out["phase_s"]}))
    return launches


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


def engine_phase(dev, record, twins):
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
    from crdt_graph_tpu_torch.ops import merge, view

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
    boot = capture_inputs(lambda: t1.apply_packed(full), wrapper_modules())
    torch.cuda.synchronize()
    steps_l["bootstrap"] = delta(s0, snap())
    t0 = time.perf_counter()
    closed_form(t1, "bootstrap")
    out["first_visible_values_ms"] = (time.perf_counter() - t0) * 1e3
    st = np.asarray(t1.table().status)[:N_OPS]
    if not np.all(st == merge.APPLIED) or t1.log_length != N_OPS:
        raise RuntimeError("engine bootstrap: some op not applied")
    routed = bulk_kernels(1 << 20)
    for k in routed:
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
        wrapper_modules())
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
    for k in set(routed) | {"plane_rows"}:
        if launches[k] < 1:
            raise RuntimeError(f"the engine phase never launched {k}")

    # every kernel call of the bootstrap and the unvouched restore (the
    # engine path's new kernel-1 shapes; kernel 5 where the route is on)
    # against its twin
    errs = {}
    for part in (boot, caught):
        for kname, e in twin_errors(part, twins).items():
            errs[kname] = max(errs.get(kname, 0.0), e)
    out["plane_rows_engine_shapes"] = [list(a[0].shape)
                                       for a, _ in caught["plane_rows"]]
    out["twin_err"] = errs
    if any(errs.values()):
        raise RuntimeError(f"a kernel disagrees with its twin in the "
                           f"engine phase: {errs}")
    del boot, caught

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


def durability_phase(dev, record, twins):
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
    from crdt_graph_tpu_torch.ops import merge

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
            if view.window(since, 4096) != packed.packed_since_window(
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
            lambda: got.update(a=recover("a", False)), wrapper_modules())
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

    # every kernel call of recovery (a), against its twin
    errs = twin_errors(caught, twins)
    out["twin_err"] = errs
    out["twin_shapes"] = {k: [list(a.shape) for a in v[0][0]
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


SHARDS = (2, 4, 8)             # logical shards of the ops-axis merge
N_HALO = 262_144               # the halo-straddling deep-paths batch


def bulk_kernels(n_rows: int):
    """The kernels a vouched bulk merge of ``n_rows`` capacity driven by
    the engine launches: the ops-axis sharded merge where its route is
    on (``--route-on`` and two or more cards), else the single-device
    merge."""
    from crdt_graph_tpu_torch.parallel import opsaxis
    if opsaxis.enabled_for(n_rows):
        return ("plane_rows", "prefix_sums", "monotone_gather",
                "ring_exclusive")
    return ("plane_rows2", "prefix_sums", "monotone_gather")


def opsaxis_phase(dev, record, adds, dels, twins):
    """The ops-axis sharded merge (``parallel.opsaxis.materialize``) on
    the card: config 5 at full width in 2, 4 and 8 logical shards, the
    with-deletes batch and a halo-straddling batch in 8, and, with two or
    more cards, config 5 with its shards on distinct cards — each table
    equal field for field to ``merge.materialize`` of the same padded
    columns on the card.  Every kernel call of those merges is recorded
    and its output held to its twin on the same inputs (kernel 1 on the
    shards' windows, kernel 3 on their chunks, kernel 4 on their rank
    chunks, kernel 5 on their carries), and kernel 5 also at edge cases;
    the sharded merge is timed beside the single-device one.  Raises on
    any mismatch.  Returns the phase's kernel launches and kernel 5's
    timed arguments."""
    import numpy as np
    import torch
    from crdt_graph_tpu_torch import convert, kernels
    from crdt_graph_tpu_torch.bench import honest, workloads
    from crdt_graph_tpu_torch.codec import packed
    from crdt_graph_tpu_torch.ops import merge, tour_scan as tsc
    from crdt_graph_tpu_torch.parallel import opsaxis

    out = {}
    halo = workloads.deep_paths(64, N_HALO)
    exp = workloads.chain_expected_ts(N_REPLICAS, N_OPS)

    def padded(arrs, k):
        n = arrs["kind"].shape[0]
        return packed.pad_arrays(arrs, -(-n // k) * k)

    def table(t):
        torch.cuda.synchronize()
        return convert.table_to_numpy(t)

    # the single-device tables of the same padded columns, on the card
    # (before the counted drive)
    ref = {"config5": table(merge.materialize(adds, hints="exhaustive",
                                              device=dev)),
           "deletes": table(merge.materialize(padded(dels, 8), hints=None,
                                              device=dev)),
           "halo": table(merge.materialize(padded(halo, 8),
                                           hints="exhaustive", device=dev))}
    runs = [("config5", adds, "exhaustive", k) for k in SHARDS] + \
        [("deletes", dels, None, 8), ("halo", halo, "exhaustive", 8)]

    # ---- the counted drive: every kernel call recorded, and held to its
    # twin after its run (the check launches nothing) -----------------
    multi = torch.cuda.device_count() >= 2
    if multi:
        # k None: mesh_devices() shards, one a card
        runs.append(("config5", adds, "exhaustive", None))
    got, per_run, ring_calls, errs, calls_n, shapes = {}, {}, [], {}, {}, {}
    mods = wrapper_modules()
    kernels.reset_launches()
    merge.host_syncs = 0
    opsaxis.halo_fallbacks = 0
    for name, arrs, hints, k in runs:
        s0 = dict(kernels.launches)
        f0 = opsaxis.halo_fallbacks
        res = []
        t0 = time.perf_counter()
        caught = capture_inputs(lambda: res.append(table(opsaxis.materialize(
            arrs, k=k, hints=hints, device=dev))), mods)
        ms = (time.perf_counter() - t0) * 1e3
        tag = f"{name}_k{k}" if k else "config5_cards"
        got[(name, k or "cards")] = res[0]
        run_err = twin_errors(caught, twins)
        per_run[tag] = {
            "ms": ms, "halo_fallbacks": opsaxis.halo_fallbacks - f0,
            "launches": {kk: kernels.launches[kk] - s0[kk] for kk in s0},
            "twin_err": run_err}
        if not k:
            per_run[tag]["k"] = opsaxis.mesh_devices()
        for kname, cases in caught.items():
            errs[kname] = max(errs.get(kname, 0.0), run_err[kname])
            calls_n[kname] = calls_n.get(kname, 0) + len(cases)
            shapes.setdefault(kname, set()).update(
                str([list(a.shape) if hasattr(a, "shape") else
                     [len(a), int(a[0].shape[0])] if isinstance(a, list)
                     else a for a in args]) for args, _ in cases)
        ring_calls += [args for args, _ in caught.get("ring_exclusive", [])]
        del caught
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    out["launches"] = launches
    out["runs"] = per_run
    out["host_syncs"] = merge.host_syncs
    out["twin_err"] = errs
    out["twin_calls"] = calls_n
    out["twin_shapes"] = {kn: sorted(v) for kn, v in shapes.items()}
    if not multi:
        log("opsaxis: the distinct-cards leg did not run (1 card: "
            "mesh_devices() == 1)")

    # ---- every table against the single-device one --------------------
    for (name, k), tab in got.items():
        want = ref[name]
        bad = [f for f in merge.FIELDS if tab[f].dtype != want[f].dtype
               or not np.array_equal(tab[f], want[f])]
        if bad:
            raise RuntimeError(f"opsaxis {name} k={k}: differs from the "
                               f"single-device merge in {bad}")
        if name == "config5":
            nv = int(tab["num_visible"])
            if nv != N_OPS or not np.array_equal(
                    tab["ts"][tab["visible_order"][:nv]], exp):
                raise RuntimeError(f"opsaxis config 5 k={k}: order wrong")
    for name, r in per_run.items():
        la = r["launches"]
        if la["ring_exclusive"] < 1 or la["plane_rows"] < 1 or \
                la["prefix_sums"] < 1 or la["monotone_gather"] < 1 or \
                la["plane_rows2"]:
            raise RuntimeError(f"opsaxis {name}: launches {la}")
    if per_run["halo_k8"]["halo_fallbacks"] < 1:
        raise RuntimeError("opsaxis halo batch never took the fallback")
    if any(r.get("halo_fallbacks", 0) for n, r in per_run.items()
           if n.startswith("config5")):
        raise RuntimeError("opsaxis config 5 took the halo fallback")
    log(f"opsaxis: config 5 ({N_OPS} ops) at k = {SHARDS} logical shards "
        f"== the single-device merge field for field, closed-form order; "
        f"with deletes ({dels['kind'].shape[0]} ops) at k = 8 equal; "
        f"deep paths ({halo['kind'].shape[0]} ops) at k = 8: "
        f"{per_run['halo_k8']['halo_fallbacks']} halo fallbacks, equal"
        + (f"; one shard a card (k = {per_run['config5_cards']['k']}) "
           f"equal" if multi else ""))
    log(f"opsaxis launches {launches}; by run "
        f"{ {n: r['launches']['ring_exclusive'] for n, r in per_run.items()} }"
        f" ring exchanges")
    for kname in ("plane_rows", "prefix_sums", "monotone_gather",
                  "ring_exclusive"):
        if not calls_n.get(kname):
            raise RuntimeError(f"opsaxis: no {kname} call was recorded")
    log(f"opsaxis: every recorded kernel call held to its twin: calls "
        f"{calls_n}, max_abs_err {errs}; argument shapes {out['twin_shapes']}")
    if any(errs.values()):
        raise RuntimeError(f"a kernel disagrees with its twin in the "
                           f"ops-axis phase: {errs}")
    fold_errors(record, errs)

    # ---- kernel 5 against its twin at edge cases -----------------------
    rng = np.random.default_rng(5)

    def on_card(rows_):
        return [torch.from_numpy(np.ascontiguousarray(r)).to(dev)
                for r in rows_.astype(np.int32)]

    edges = [(on_card(rng.integers(-9, 9, (1, 5))), "add"),
             (on_card(rng.integers(-9, 9, (1, 1))), "max"),
             (on_card(rng.integers(-50, 20, (8, 1))), "max"),
             (on_card(rng.integers(-50, 20, (8, 5))), "max"),
             (on_card(np.full((8, 5), 2**31 - 7)), "add"),
             (on_card(rng.integers(-2**31, 2**31 - 1, (8, 1),
                                   dtype=np.int64)), "add")]
    e_err = twin_errors(capture_inputs(
        lambda: [tsc.ring_exclusive(*c) for c in edges],
        wrapper_modules(["ring_exclusive"])), twins)["ring_exclusive"]
    fold_errors(record, {"ring_exclusive": e_err})
    rec5 = record["kernels"]["ring_exclusive"]
    rec5.update({"cases": len(ring_calls) + len(edges),
                 "checked_shapes": sorted(
                     {(len(v), int(v[0].shape[0]), op)
                      for v, op in ring_calls + edges})})
    log(f"kernel ring_exclusive: {len(ring_calls)} recorded calls of the "
        f"drive + {len(edges)} edge cases vs twin (k, L, op in "
        f"{rec5['checked_shapes']}), max_abs_err {rec5['max_abs_err']}")
    if rec5["max_abs_err"] != 0:
        raise RuntimeError("ring_exclusive disagrees with its twin")
    timed = next(c for c in ring_calls
                 if c[1] == "add" and c[0][0].shape[0] > 1
                 and len(c[0]) == 8)

    # ---- timing: k = 8 sharded (and one shard a card) beside the
    # single-device merge, in turns -------------------------------------
    fns = {"single": lambda: merge.materialize(adds, hints="exhaustive",
                                               device=dev),
           "opsaxis_k8": lambda: opsaxis.materialize(
               adds, k=8, hints="exhaustive", device=dev),
           "opsaxis_cards": lambda: opsaxis.materialize(
               adds, hints="exhaustive", device=dev)}
    order = ["single", "opsaxis_k8"] + ["opsaxis_cards"] * 2 * multi + \
        ["opsaxis_k8", "single"]
    legs = {}
    for name in order:
        legs.setdefault(name, []).extend(honest.time_with_readback(
            fns[name], repeats=3)["times_ms"])
    out["timing_ms"] = {n: {"p50": float(np.median(v)), "times": v}
                        for n, v in legs.items()}
    s, o = (out["timing_ms"][n]["p50"] for n in ("single", "opsaxis_k8"))
    log(f"opsaxis timing at {N_OPS}: single-device p50 {s:.3f} ms, k = 8 "
        f"sharded p50 {o:.3f} ms ({o / s:.2f}x); host syncs of the counted "
        f"drive {out['host_syncs']}")
    if multi:
        c = out["timing_ms"]["opsaxis_cards"]["p50"]
        log(f"opsaxis timing at {N_OPS}: one shard a card (k = "
            f"{per_run['config5_cards']['k']}) p50 {c:.3f} ms "
            f"({c / s:.2f}x the single-device merge)")
    record["opsaxis"] = out
    return launches, timed


N_DOCS = 8                     # documents the serve phase hosts
N_WRITES, N_LEAVES = 24, 12   # a writer session (scripts/bench_serve_headline)
# the serve phase's writer sessions and their writes: cut from 64 x 24
# to keep the script inside its time with the walshared phase (whose
# writers run the full 24 on every document)
SERVE_WRITERS, SERVE_WRITES = 16, 8
N_READERS = 8
N_STAGED = 4096                # docs 1-7's staged bootstraps (kernel route)
BACKSPACE_P = 0.1              # a writer's chance to delete its last char
CALL_S = 120.0                 # every client call's timeout
MESH_WIDTHS = (1, 4, 16)       # documents of the batched merge timing
N_MESH = 65_536                # ops of each of them


class Client:
    """One keep-alive HTTP connection to the served port; every call
    carries the connection's timeout, so a hung request fails the phase
    instead of hanging it."""

    def __init__(self, port: int, timeout: float = CALL_S):
        from http.client import HTTPConnection
        self.conn = HTTPConnection("127.0.0.1", port, timeout=timeout)

    def call(self, method, path, body=None, headers=None):
        """``(status, body, response)`` of one request."""
        self.conn.request(method, path, body=body, headers=headers or {})
        resp = self.conn.getresponse()
        return resp.status, resp.read(), resp

    def json(self, method, path, body=None, want=200):
        st, raw, _ = self.call(method, path, body=body)
        if st != want:
            raise RuntimeError(f"{method} {path} -> {st}: {raw[:200]!r}")
        return json.loads(raw)

    def close(self):
        self.conn.close()


def run_threads(threads, timeout: float):
    """Start ``threads``, join each within ``timeout`` overall, and raise
    the first error any of them recorded (``t.error``)."""
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    hung = [t.name for t in threads if t.is_alive()]
    if hung:
        raise RuntimeError(f"threads still running after {timeout} s: "
                           f"{hung[:4]}")
    for t in threads:
        if t.error is not None:
            raise RuntimeError(f"{t.name}: {t.error!r}") from t.error


class Worker(threading.Thread):
    """A daemon thread that records its exception instead of printing."""

    def __init__(self, name, fn):
        super().__init__(name=name, daemon=True)
        self.fn, self.error, self.result = fn, None, None

    def run(self):
        try:
            self.result = self.fn()
        except BaseException as e:   # noqa: BLE001 — reported by run_threads
            self.error = e


def write_session(port, doc, idx, n_writes=N_WRITES):
    """One writer session on ``doc``: claim a replica id, then push
    ``n_writes`` deltas of ``N_LEAVES`` leaves (each leaf an add after
    the session's last character, or, with ``BACKSPACE_P``, a delete of
    it), retrying a 429; each ack is checked and followed by a read of
    the write's newest add.  Returns ``(doc, alive values, deleted
    values, ack ms a write)``."""
    import random
    from crdt_graph_tpu_torch.codec import json_codec
    from crdt_graph_tpu_torch.core.operation import Add, Batch, Delete
    cl = Client(port)
    rid = cl.json("POST", f"/docs/{doc}/replicas")["replica"]
    rng = random.Random(1000 + idx)
    alive, gone, ms, counter = [], [], [], 0
    for w in range(n_writes):
        ops = []
        for _ in range(N_LEAVES):
            if alive and rng.random() < BACKSPACE_P:
                ts, v = alive.pop()
                ops.append(Delete((ts,)))
                gone.append(v)
            else:
                counter += 1
                ts = rid * 2**32 + counter
                ops.append(Add(ts, (alive[-1][0] if alive else 0,),
                               f"s{idx}.{counter}"))
                alive.append((ts, f"s{idx}.{counter}"))
        body = json_codec.dumps(Batch(tuple(ops)))
        while True:
            t0 = time.perf_counter()
            st, raw, _ = cl.call("POST", f"/docs/{doc}/ops", body=body)
            if st != 429:
                break
            time.sleep(0.05)
        ms.append((time.perf_counter() - t0) * 1e3)
        a = json.loads(raw)
        if st != 200 or not a["accepted"] \
                or a["applied_count"] != N_LEAVES:
            raise RuntimeError(f"{doc} write {w} -> {st} {a}")
        # read-your-writes: the served log holds the write's newest add
        # (its window from there is found)
        last = max((o.ts for o in ops if isinstance(o, Add)), default=None)
        if last is not None:
            st, _, r = cl.call("GET",
                               f"/docs/{doc}/ops?since={last}&limit=1")
            if st != 200 or r.getheader("X-Since-Found") != "1":
                raise RuntimeError(f"{doc}: write {w} not read back ({st})")
    cl.close()
    return doc, [v for _, v in alive], gone, ms


def acked_read_back(values, result):
    """Whether a document's served ``values`` hold a writer session's
    acked adds in order and none of its deleted values."""
    _, alive, gone, _ = result
    pos = {v: i for i, v in enumerate(values) if isinstance(v, str)}
    got = [pos.get(v) for v in alive]
    return None not in got and got == sorted(got) and \
        not any(v in pos for v in gone)


def serve_phase(dev, record, twins, card):
    """The wire service on the card: ``make_server`` (the port's
    ``ServingEngine`` on the card, durable, ``GRAFT_WAL_SYNC=commit``)
    hosting 8 documents on 127.0.0.1.  Document 0 bootstraps by one
    ``POST`` of config 5 as wire JSON (native ingest, chunked merges on the
    card); documents 1-7 bootstrap in one staged round whose same-bucket
    kernel merges group into one batched merge; then 16 writer sessions
    push 8 12-leaf chain deltas each while 8 readers read and one
    watcher follows document 1 by long-poll ``/watch``.  Every acked
    write reads back, before and after a restart on the same directory;
    each document's ``/ops?since=0`` replays into a fresh CPU replica to
    the served values; ``/metrics/prom`` parses; shutdown leaves no
    thread.  Returns the kernel launches of the served drive."""
    import os
    import shutil
    import numpy as np
    from crdt_graph_tpu_torch import engine as engine_mod, kernels
    from crdt_graph_tpu_torch.bench import workloads
    from crdt_graph_tpu_torch.codec import json_codec, packed as packed_mod
    from crdt_graph_tpu_torch.core.operation import Add, Batch
    from crdt_graph_tpu_torch.obs import prom
    from crdt_graph_tpu_torch.service import make_server

    root = ROOT / "build" / "serve"
    shutil.rmtree(root, ignore_errors=True)
    env = {"GRAFT_DURABLE_DIR": str(root), "GRAFT_WAL_SYNC": "commit"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = {"docs": N_DOCS, "writers": SERVE_WRITERS, "writes": SERVE_WRITES,
           "leaves": N_LEAVES, "readers": N_READERS, "card": card}

    def start():
        srv = make_server(port=0)          # device=None: the card
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        if srv.store.device != dev:
            raise RuntimeError(f"served engine on {srv.store.device}")
        return srv, th

    def stop(srv, th):
        eng = srv.store
        srv.shutdown()
        srv.server_close()                 # closes the owned engine
        th.join(60)
        lanes = [t for t in (th, eng.scheduler, eng.maintenance,
                             eng.sync_worker) if t is not None]
        left = [t.name for t in lanes if t.is_alive()]
        if left:
            raise RuntimeError(f"shutdown left threads running: {left}")

    def values_of(c, doc):
        return c.json("GET", f"/docs/{doc}")["values"]

    try:
        srv, th = start()
        eng, port = srv.store, srv.server_port
        kernels.reset_launches()
        c = Client(port, timeout=600.0)

        # ---- document 0: config 5 in one POST (native ingest) ---------
        for _ in range(N_REPLICAS):        # the 64 replicas claim their ids
            rid = c.json("POST", "/docs/d0/replicas")["replica"]
        if rid != N_REPLICAS:
            raise RuntimeError(f"replica ids ran to {rid}")
        arrs = workloads.chain_workload(N_REPLICAS, N_OPS)
        wire = packed_mod.packed_since_bytes(packed_chain(arrs, N_OPS), 0)
        t0 = time.perf_counter()
        ack = c.json("POST", "/docs/d0/ops", body=wire)
        out["giant_commit_ms"] = (time.perf_counter() - t0) * 1e3
        out["giant_wire_bytes"] = len(wire)
        if not ack["accepted"] or ack["applied_count"] != N_OPS:
            raise RuntimeError(f"bootstrap ack {ack}")
        del wire
        if not eng.flush(CALL_S):
            raise RuntimeError("the bootstrap never flushed")
        giant = eng.flight.records()[-1].to_json()
        out["giant_stages_ms"] = giant["stages_ms"]
        out["giant_chunks"] = giant["chunk_count"]
        log(f"serve: d0 bootstrap POST of {N_OPS} ops ({out['giant_wire_bytes']}"
            f" wire bytes) acked in {out['giant_commit_ms']:.1f} ms; commit "
            f"stages {out['giant_stages_ms']} ms, {out['giant_chunks']} chunks")

        # ---- documents 1-7: one staged round, grouped on the card -----
        def bootstrap(k):
            cl = Client(port)
            rid = cl.json("POST", f"/docs/d{k}/replicas")["replica"]
            ops = [Add(rid * 2**32 + i, ((rid * 2**32 + i - 1) if i > 1
                                         else 0,), f"b{k}.{i}")
                   for i in range(1, N_STAGED + 1)]
            body = json_codec.dumps(Batch(tuple(ops)))
            a = cl.json("POST", f"/docs/d{k}/ops", body=body)
            cl.close()
            if a["applied_count"] != N_STAGED:
                raise RuntimeError(f"d{k} bootstrap ack {a}")

        for k in range(1, N_DOCS):
            eng.get(f"d{k}")
        # the scheduler holds its rounds until all seven pushes queue
        eng.scheduler.pause()
        boots = [Worker(f"boot-d{k}", lambda k=k: bootstrap(k))
                 for k in range(1, N_DOCS)]

        def staged_round():
            for t in boots:
                t.start()
            deadline = time.monotonic() + CALL_S
            while sum(len(eng.get(f"d{k}").queue)
                      for k in range(1, N_DOCS)) < N_DOCS - 1:
                if time.monotonic() > deadline or any(
                        t.error for t in boots):
                    raise RuntimeError("staged pushes never queued")
                time.sleep(0.005)
            eng.scheduler.resume()
            for t in boots:
                t.join(CALL_S)
            if not eng.flush(CALL_S):
                raise RuntimeError("staged round never flushed")

        batches0 = eng.counters.get("cross_doc_batches")
        caught = capture_inputs(staged_round, wrapper_modules())
        for t in boots:
            if t.is_alive() or t.error:
                raise RuntimeError(f"{t.name}: {t.error!r}")
        grouped = eng.counters.get("cross_doc_batches") - batches0
        widths = sorted({r.batch_width for r in eng.flight.records()
                         if r.batch_width})
        if grouped < 1:
            raise RuntimeError("the staged round never grouped on the card")
        errs = twin_errors(caught, twins)
        for k in BATCHED_JOIN:
            if k not in errs:
                raise RuntimeError(f"the batched merge never called {k}")
        if any(e != 0 for e in errs.values()):
            raise RuntimeError(f"batched-merge kernel calls differ: {errs}")
        fold_errors(record, errs)
        out["cross_doc_batches"] = grouped
        out["batch_widths"] = widths
        out["batched_twin_calls"] = {k: len(v) for k, v in caught.items()}
        log(f"serve: staged round of {N_DOCS - 1} bootstraps -> "
            f"{grouped} batched merge(s) of widths {widths}; "
            f"{out['batched_twin_calls']} kernel calls == twins")
        del caught

        # ---- 16 writers and 8 readers ---------------------------------
        stop_reads = threading.Event()

        def writer(idx):
            return write_session(port, f"d{idx % N_DOCS}", idx,
                                 SERVE_WRITES)

        def reader(idx):
            cl = Client(port)
            ms, i = [], 0
            since = N_REPLICAS * 2**32 + 15_000
            while not stop_reads.is_set():
                k = (idx + i) % N_DOCS
                i += 1
                path = (f"/docs/d0/ops?since={since}&limit=256"
                        if k == 0 and i % 2 else
                        "/docs/d0/clock" if k == 0 else f"/docs/d{k}")
                t0 = time.perf_counter()
                st, _, _ = cl.call("GET", path)
                ms.append((time.perf_counter() - t0) * 1e3)
                if st != 200:
                    raise RuntimeError(f"read {path} -> {st}")
            cl.close()
            return ms

        def watcher():
            """Follows d1 by long-poll ``/watch`` on one keep-alive
            connection (parked on the reactor between generations) into
            a CPU replica, until the writers are done and a poll times
            out caught up."""
            cl = Client(port)
            replica = engine_mod.init(998, device="cpu")
            mark, events = 0, {}
            while True:
                # a poll that starts after the last ack and times out
                # has seen every write
                last = stop_reads.is_set()
                st, raw, r = cl.call(
                    "GET", f"/docs/d1/watch?since={mark}&timeout=1")
                ev = r.getheader("X-Watch-Event")
                if st != 200:
                    raise RuntimeError(f"watch d1 -> {st} {ev}")
                events[ev] = events.get(ev, 0) + 1
                if ev == "timeout":
                    if last:
                        break
                    continue
                replica.apply_wire(raw)
                mark = int(r.getheader("X-Since-Next"))
            cl.close()
            return replica.visible_values(), events

        writers = [Worker(f"writer-{i}", lambda i=i: writer(i))
                   for i in range(SERVE_WRITERS)]
        readers = [Worker(f"reader-{i}", lambda i=i: reader(i))
                   for i in range(N_READERS)]
        readers.append(Worker("watcher-d1", watcher))
        for t in readers:
            t.start()
        t0 = time.perf_counter()
        try:
            run_threads(writers, 600.0)
        finally:
            wall = time.perf_counter() - t0
            stop_reads.set()
            for t in readers:
                t.join(CALL_S)
        for t in readers:
            if t.is_alive() or t.error:
                raise RuntimeError(f"{t.name}: {t.error!r}")
        watched, watch_events = readers.pop().result
        if not eng.flush(CALL_S):
            raise RuntimeError("the served engine never flushed")
        launches = dict(kernels.launches)
        leaves = SERVE_WRITERS * SERVE_WRITES * N_LEAVES
        # where a writer commit's time goes: p50 of each flight-record
        # stage, document 0 (1M values) apart from the small documents
        stages = {"d0": {}, "d1-7": {}}
        n_commits = {"d0": 0, "d1-7": 0}
        for r in eng.flight.records():
            if r.num_ops > N_LEAVES * SERVE_WRITERS \
                    or r.outcome != "committed":
                continue
            key = "d0" if r.doc_id == "d0" else "d1-7"
            n_commits[key] += 1
            for st_name, v in r.stages_ms.items():
                stages[key].setdefault(st_name, []).append(v)
            stages[key].setdefault("total", []).append(r.total_ms)
        out["writer_commits"] = n_commits
        out["writer_stage_p50_ms"] = {
            k: {n: float(np.percentile(v, 50)) for n, v in d.items()}
            for k, d in stages.items()}
        commit_ms = [m for t in writers for m in t.result[3]]
        read_ms = [m for t in readers for m in t.result]
        out.update({
            "acked_writes": SERVE_WRITERS * SERVE_WRITES,
            "acked_leaves": leaves,
            "writer_wall_s": wall, "sustained_ops_per_s": leaves / wall,
            "commit_p50_ms": float(np.percentile(commit_ms, 50)),
            "commit_p99_ms": float(np.percentile(commit_ms, 99)),
            "reads": len(read_ms),
            "read_p50_ms": float(np.percentile(read_ms, 50)),
            "read_p99_ms": float(np.percentile(read_ms, 99)),
            "launches": launches,
            "coalesce": eng.counters.get("fused_batches")})
        # document 0's giant single takes the vouched leg; the grouped
        # round is one batched merge on the join leg
        for k in ("plane_rows2", "prefix_sums", "monotone_gather",
                  *BATCHED_JOIN):
            if launches.get(k, 0) < 1:
                raise RuntimeError(f"the served path never launched {k}")

        # ---- what the service serves -----------------------------------
        exp_ts = workloads.chain_expected_ts(N_REPLICAS, N_OPS)
        per = N_OPS // N_REPLICAS
        exp_rows = ((exp_ts >> 32) - 1) * per + (exp_ts & 0xFFFFFFFF) - 1

        def check_served(c, tag):
            served = {}
            for k in range(N_DOCS):
                served[k] = values_of(c, f"d{k}")
            ints = np.array([v for v in served[0] if isinstance(v, int)])
            if not np.array_equal(ints, exp_rows):
                raise RuntimeError(f"{tag}: d0's bootstrap order wrong")
            for t in writers:
                doc = t.result[0]
                if not acked_read_back(served[int(doc[1:])], t.result):
                    raise RuntimeError(f"{tag}: {t.name}'s acked writes "
                                       f"do not read back on {doc}")
            for k in range(1, N_DOCS):
                if sum(1 for v in served[k] if str(v).startswith(
                        f"b{k}.")) != N_STAGED:
                    raise RuntimeError(f"{tag}: d{k} lost its bootstrap")
            return served

        served = check_served(c, "live")
        if watched != served[1]:
            raise RuntimeError("d1 followed by /watch differs from the "
                               "served values")
        out["watch_events"] = watch_events
        t0 = time.perf_counter()
        for k in range(N_DOCS):
            st, body, _ = c.call("GET", f"/docs/d{k}/ops?since=0")
            replica = engine_mod.init(999, device="cpu")
            replica.apply_wire(body)
            if replica.visible_values() != served[k]:
                raise RuntimeError(f"d{k}: /ops?since=0 replayed on the "
                                   "CPU differs from the served values")
        out["replay_s"] = time.perf_counter() - t0
        fams = prom.parse_text(c.call("GET", "/metrics/prom")[1].decode())
        out["prom_families"] = len(fams)
        flight = c.json("GET", "/debug/flight")
        out["flight_records"] = len(flight["records"])
        out["flight_audit"] = flight_audits([eng.flight], "serve")
        c.close()
        stop(srv, th)

        # ---- restart on the same directory ----------------------------
        t0 = time.perf_counter()
        srv, th = start()
        out["restart_s"] = time.perf_counter() - t0
        c = Client(srv.server_port, timeout=600.0)
        again = check_served(c, "restart")
        if again != served:
            raise RuntimeError("the restarted server serves other values")
        c.close()
        stop(srv, th)
        log("serve: " + json.dumps({
            "card": card, "acked_writes": out["acked_writes"],
            "acked_leaves": leaves,
            "sustained_ops_per_s": round(out["sustained_ops_per_s"], 1),
            "read_p50_ms": round(out["read_p50_ms"], 3),
            "read_p99_ms": round(out["read_p99_ms"], 3),
            "commit_p50_ms": round(out["commit_p50_ms"], 3),
            "giant_commit_ms": round(out["giant_commit_ms"], 1),
            "cross_doc_batches": grouped, "batch_widths": widths,
            "flight_audit": out["flight_audit"],
            "launches": launches}))
        log(f"serve: writer commits {n_commits}, p50 stage ms "
            + json.dumps({k: {n: round(v, 3) for n, v in d.items()}
                          for k, d in out["writer_stage_p50_ms"].items()}))
        log(f"serve: every acked write read back, live and after a restart "
            f"({out['restart_s']:.1f} s); each document's /ops?since=0 == "
            f"its served values on a CPU replica ({out['replay_s']:.1f} s); "
            f"d1 followed by long-poll /watch {watch_events} == its served "
            f"values; "
            f"/metrics/prom {len(fams)} families; shutdown clean")
        record["serve"] = out
        return launches
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)


def mesh_phase(dev, record, twins, card):
    """The docs-axis batched merge on the card (its own counted drive).
    16 documents of 65,536 chain ops (4 to 512 replicas each) merge as
    ONE batched merge (``parallel.mesh.batched_materialize``: one chain
    of dispatches and host reads over a leading document axis, each
    kernel's batched form launched once a batch) at B = 1, 4 and 16,
    timed beside the same B documents merged one by one (the join leg
    the batch runs, and the vouched leg a single commit would take).

    At B = 16 both legs of the batch (the default join leg, and
    ``exhaustive_hints=True``) run counted from zero: each leg launches
    every kernel of its single merge as often as ONE single merge does
    (not 16 times), and nothing else; every kernel call equals its
    batched twin; every document's slice of either leg equals its own
    single join merge field for field.  The trace audit counts the
    batch's device ops, reads and kernel calls beside one single
    merge's, and the batch's peak device memory is read.  Returns the
    counted drive's launches and, by batched kernel, the arguments of
    its first call (the kernels' timing takes them)."""
    import numpy as np
    import torch
    from crdt_graph_tpu_torch import convert, kernels
    from crdt_graph_tpu_torch.bench import honest, workloads
    from crdt_graph_tpu_torch.ops import merge
    from crdt_graph_tpu_torch.parallel import mesh
    from crdt_graph_tpu_torch.utils import chainaudit

    docs = [packed_chain(workloads.chain_workload(4 << (i % 8), N_MESH),
                         N_MESH) for i in range(max(MESH_WIDTHS))]
    out = {"ops_per_doc": N_MESH, "card": card, "widths": {}}
    for b in MESH_WIDTHS:
        stacked, aligned = mesh.stack_aligned(docs[:b])
        cols = [p.arrays() for p in aligned]   # host columns, made once
        legs = {
            "batched": lambda: mesh.batched_materialize(stacked, device=dev),
            "singles_join": lambda: [merge.materialize(
                a, hints="join", device=dev) for a in cols],
            "singles_vouched": lambda: [merge.materialize(
                a, hints="exhaustive", device=dev) for a in cols]}
        times = {}
        for name in ("batched", "singles_join", "singles_vouched",
                     "singles_join", "batched"):
            times.setdefault(name, []).extend(honest.time_with_readback(
                legs[name], repeats=5)["times_ms"])
        row = {n: float(np.median(v)) / b for n, v in times.items()}
        out["widths"][b] = {"per_doc_ms": row, "times_ms": times}

    # ---- B = 16, both legs, counted ------------------------------------
    b = max(MESH_WIDTHS)
    stacked, aligned = mesh.stack_aligned(docs[:b])
    cols = [p.arrays() for p in aligned]
    runs = {"join": lambda: mesh.batched_materialize(stacked, device=dev),
            "vouched": lambda: mesh.batched_materialize(
                stacked, device=dev, exhaustive_hints=True)}
    single_hints = {"join": "join", "vouched": "exhaustive"}
    # what one single merge of each leg launches: the batch's expectation
    expect = {}
    for leg, hints in single_hints.items():
        kernels.reset_launches()
        merge.materialize(cols[0], hints=hints, device=dev)
        torch.cuda.synchronize()
        expect[leg] = {k + "_batched": n for k, n in kernels.launches.items()
                       if n}
    want_join = [convert.table_to_numpy(merge.materialize(
        c, hints="join", device=dev)) for c in cols]
    got = {}
    torch.cuda.synchronize()
    kernels.reset_launches()
    caught = capture_inputs(
        lambda: [got.setdefault(leg, fn()) for leg, fn in runs.items()],
        wrapper_modules())
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    want = {}
    for leg in runs:
        for k, n in expect[leg].items():
            want[k] = want.get(k, 0) + n
    if {k: n for k, n in launches.items() if n} != want:
        raise RuntimeError(f"the B = {b} batches launched {launches}, want "
                           f"{want} (one single merge's kernels a leg)")
    for k in BATCHED_JOIN:
        if launches[k] < 1:
            raise RuntimeError(f"the batched merge never launched {k}")
    errs = twin_errors(caught, twins)
    if any(e != 0 for e in errs.values()) or set(errs) != set(want):
        raise RuntimeError(f"batched kernel calls differ: {errs}")
    fold_errors(record, errs)
    for leg, btab in got.items():
        for i in range(b):
            s = convert.table_to_numpy(mesh.doc_table(btab, i))
            bad = [f for f in merge.FIELDS
                   if s[f].dtype != want_join[i][f].dtype
                   or not np.array_equal(s[f], want_join[i][f])]
            if bad:
                raise RuntimeError(f"{leg} batch: doc {i}'s slice != its "
                                   f"single merge in {bad}")
    args = {k: v[0][0] for k, v in caught.items()}
    out["twin_calls"] = {k: len(v) for k, v in caught.items()}
    out["launches_per_batch"] = {leg: expect[leg] for leg in runs}
    out["launches"] = launches
    del caught, got

    # ---- the trace audit: one batch against one single merge -----------
    nd = merge.host_no_deletes(stacked["kind"])
    audit = {}
    for leg, hints in single_hints.items():
        for what, arrs in (("single", cols[0]), (f"batch{b}", stacked)):
            a = chainaudit.audit_materialize(arrs, hints, nd, dev)
            audit[f"{leg}_{what}"] = {
                "device_ops": a.device_ops, "read_syncs": a.read_syncs,
                "host_syncs": a.host_syncs, "kernel_calls": a.kernel_calls,
                "merges": a.merges}
    out["audit"] = audit

    # ---- the batch's peak device memory --------------------------------
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    runs["join"]()
    torch.cuda.synchronize()
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    out["peak_mem_over_base_bytes"] = out["peak_mem_bytes"] - base
    record["mesh"] = out
    log("mesh: " + json.dumps({
        "card": card, "ops_per_doc": N_MESH, "path":
        "mesh.batched_materialize: one merge over a leading document axis",
        "per_doc_ms": {b_: {n: round(v, 4) for n, v in
                            out["widths"][b_]["per_doc_ms"].items()}
                       for b_ in MESH_WIDTHS},
        "launches_per_batch": out["launches_per_batch"],
        "audit": audit, "peak_mem_bytes": out["peak_mem_bytes"],
        "peak_mem_over_base_bytes": out["peak_mem_over_base_bytes"]}))
    log(f"mesh: B = {b}, both legs: slices == single merges; "
        f"{out['twin_calls']} kernel calls == batched twins; launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    return launches, args



MD_DEVICES = 8                 # logical devices of the multidevice phase
MD_MESH = (4, 2)               # its 2-D mesh: docs x ops
MD_DOCS = 8                    # bench_docs_axis's documents, and the fleet's
MD_PROCS = 2                   # processes of the two-process leg
MD_CHILD_TIMEOUT_S = 300       # each of them at most
MD_REPEATS = 5                 # timed repeats of each single-merge path
# bench_docs_axis's batched_vs_seq at 8 x 1M on one H100 when the docs
# axis ran its merges back to back, one per document (PERF.md, section
# 5): printed beside this run's
DOCS_AXIS_BACK_TO_BACK = 0.995


def md_fingerprints(table):
    """Per-document content scalar of a (batched) table: the sum of the
    visible timestamps mod a prime (the reference fleet test's)."""
    import torch
    return torch.where(table.visible, table.ts % 1000003, 0).sum(-1)


def multidevice_child(port: int, rank: int, out_dir: str) -> int:
    """``--multidevice-child PORT RANK DIR``: one process of the phase's
    two-process leg.  Joins ``parallel.distributed`` (``gloo`` on one
    card, ``nccl`` with a card each), merges its ``MD_DOCS / MD_PROCS``
    documents through ``host_local_docs_to_global`` +
    ``batched_materialize`` (every kernel call held to its twin),
    exchanges the fingerprints over the store and checks all of them
    against its own single merges; writes ``DIR/rank<R>.json``."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    from crdt_graph_tpu_torch import kernels
    from crdt_graph_tpu_torch.kernels import build
    from crdt_graph_tpu_torch.ops import merge
    from crdt_graph_tpu_torch.parallel import distributed, mesh
    from crdt_graph_tpu_torch.scripts import bench_docs_axis
    build.load()                   # built by the parent: loaded, not built
    distributed.initialize(f"127.0.0.1:{port}", num_processes=MD_PROCS,
                           process_id=rank)
    card = (distributed.default_local_devices()
            or [merge.resolve_device(None)])[0]
    per = MD_DOCS // MD_PROCS
    m = distributed.global_device_mesh(1, local_devices=[card] * per)
    docs = [bench_docs_axis._doc_workload(d, N_OPS)
            for d in range(rank * per, (rank + 1) * per)]
    stacked = {k: np.stack([d[k] for d in docs]) for k in docs[0]}
    del docs
    g = distributed.host_local_docs_to_global(stacked, m)
    kernels.reset_launches()
    got = {}
    caught = capture_inputs(
        lambda: got.setdefault("t", mesh.batched_materialize(g, m)),
        wrapper_modules())
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    errs = twin_errors(caught, twin_fns())
    calls = {k: len(v) for k, v in caught.items()}
    del caught
    base = rank * per
    fp = distributed.allgather_scalars(
        "md-fp", {base + i: int(v) for i, v in
                  enumerate(md_fingerprints(got["t"]).tolist())})
    nv = distributed.allgather_scalars(
        "md-nv", {base + i: int(v)
                  for i, v in enumerate(got["t"].num_visible.tolist())})
    for d in range(MD_DOCS):
        one = merge.materialize(bench_docs_axis._doc_workload(d, N_OPS),
                                device=card)
        want = int(md_fingerprints(one))
        if fp[d] != want or nv[d] != int(one.num_visible):
            raise RuntimeError(f"rank {rank}: document {d} fingerprint "
                               f"{fp[d]} (single merge {want}), visible "
                               f"{nv[d]}")
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "backend": distributed.backend(), "device": str(card),
        "fingerprints": [fp[d] for d in range(MD_DOCS)],
        "launches": launches, "twin_err": errs, "twin_calls": calls}))
    distributed.shutdown()
    return 0


def md_spawn(out):
    """Start the two-process leg's children, each in its own process
    group; returns [(proc, log files)]."""
    import os
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    kids = []
    for r in range(MD_PROCS):
        files = (open(out / f"stdout{r}.log", "w"),
                 open(out / f"stderr{r}.log", "w"))
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--multidevice-child", str(port), str(r), str(out)],
            stdout=files[0], stderr=files[1], cwd=str(ROOT),
            start_new_session=True, env=dict(os.environ, PYTHONUNBUFFERED="1"))
        kids.append((proc, files))
    return kids


def md_stop(kids) -> None:
    """End every child of the two-process leg and its group."""
    import os
    import signal
    for proc, files in kids:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
        for f in files:
            f.close()


def md_join(kids, out) -> list:
    """Wait for the two-process leg (at most ``MD_CHILD_TIMEOUT_S`` in
    all) and return the ranks' results; a non-zero exit or a timeout
    kills both and raises with their output."""
    deadline = time.monotonic() + MD_CHILD_TIMEOUT_S
    rcs = []
    for proc, _ in kids:
        try:
            rcs.append(proc.wait(max(0.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            rcs.append(None)
    md_stop(kids)
    if any(rc != 0 for rc in rcs):
        for r in range(MD_PROCS):
            print(f"--- multidevice child {r} (rc {rcs[r]}) ---\n"
                  + (out / f"stdout{r}.log").read_text()[-3000:]
                  + (out / f"stderr{r}.log").read_text()[-6000:],
                  file=sys.stderr, flush=True)
        raise RuntimeError(f"multidevice two-process leg: exit codes {rcs}"
                           " (None: killed at the time limit)")
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(MD_PROCS)]


def multidevice_phase(dev, record, adds, dels, twins, card):
    """The multi-device layer on the card (``parallel.shard``,
    ``parallel.mesh``'s mesh forms, ``parallel.dryrun``,
    ``scripts.bench_docs_axis``, ``parallel.distributed``), on
    ``MD_DEVICES`` logical devices (``mesh.logical_devices``: the one
    card ``MD_DEVICES`` times, or the visible cards in turn):

    - ``shard_materialize`` of config 5 at full width in ``"auto"`` and
      ``"exhaustive"``, of the deletes batch and of a hostile-hints copy
      (permuted ranks, zeroed anchor links: it must fall back), and
      ``sharded_materialize`` of config 5, each equal in every field to
      ``merge.materialize`` of the same padded columns on the card;
    - a 2-D mesh (docs 4 × ops 2, ``shard_ops_axis=True``) over four
      config-5-shaped documents, each slice equal to its own merge;
      ``dryrun_multichip(MD_DEVICES, device="cuda")``;
      ``bench_docs_axis.run()`` at 8 × 1M, every document fully visible;
    - two processes of ``torch.distributed`` (children of this one,
      started first and joined after the runs above), each merging its
      4 of the 8 documents; their fingerprints agree with each other
      and with this process's single merges;
    - every kernel call of the runs (the children's too) held to its
      twin; the single merge, ``shard_materialize`` and
      ``sharded_materialize`` timed in turns, with each path's
      collective bytes.

    Returns the phase's kernel launches (the children's included)."""
    import shutil
    out = ROOT / "build" / "multidevice"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    kids = md_spawn(out)
    try:
        return _multidevice_runs(dev, record, adds, dels, twins, card, out,
                                 kids)
    finally:
        md_stop(kids)


def _multidevice_runs(dev, record, adds, dels, twins, card, out, kids):
    import numpy as np
    import torch
    from crdt_graph_tpu_torch import convert, kernels
    from crdt_graph_tpu_torch.bench import honest
    from crdt_graph_tpu_torch.codec import packed
    from crdt_graph_tpu_torch.ops import merge
    from crdt_graph_tpu_torch.parallel import (collectives, dryrun_multichip,
                                               mesh, shard)
    from crdt_graph_tpu_torch.scripts import bench_docs_axis

    devs = mesh.logical_devices(MD_DEVICES)
    m1 = mesh.make_mesh(1, MD_DEVICES, devices=devs)
    m2 = mesh.make_mesh(*MD_MESH, devices=devs)
    res = {"card": card, "devices": [str(d) for d in devs],
           "distinct_cards": len(set(devs)), "reduced": []}
    log(f"multidevice: {MD_DEVICES} logical devices {res['devices']} "
        f"({res['distinct_cards']} distinct card(s))")

    def table(t):
        torch.cuda.synchronize()
        return convert.table_to_numpy(t)

    k = MD_DEVICES
    dels_p = packed.pad_arrays(dels, -(-dels["kind"].shape[0] // k) * k)
    hostile = dict(adds)
    rng = np.random.default_rng(7)
    r = adds["ts_rank"].copy()
    a = np.nonzero(r >= 0)[0]
    r[a] = rng.permutation(r[a])
    hostile["ts_rank"] = r
    bad = adds["anchor_pos"].copy()
    bad[bad >= 0] = 0
    hostile["anchor_pos"] = bad
    docs4 = [bench_docs_axis._doc_workload(d, N_OPS)
             for d in range(MD_MESH[0])]
    stacked4 = {c: np.stack([d[c] for d in docs4]) for c in docs4[0]}

    # the single-device tables of the same padded columns (uncounted)
    ref = {"config5": table(merge.materialize(adds, hints="exhaustive",
                                              device=dev)),
           "deletes": table(merge.materialize(dels_p, device=dev)),
           "hostile": table(merge.materialize(hostile, device=dev))}
    ref4 = [table(merge.materialize(d, hints="exhaustive", device=dev))
            for d in docs4]
    fp4 = [int(md_fingerprints(merge.materialize(d, device=dev)))
           for d in docs4]

    def same(tab, want, what):
        badf = [f for f in merge.FIELDS if tab[f].dtype != want[f].dtype
                or not np.array_equal(tab[f], want[f])]
        if badf:
            raise RuntimeError(f"multidevice {what}: differs from the "
                               f"single-device merge in {badf}")

    runs = [
        ("shard_auto", "config5",
         lambda: shard.shard_materialize(adds, m1, hints="auto")),
        ("shard_exhaustive", "config5",
         lambda: shard.shard_materialize(adds, m1, hints="exhaustive")),
        ("shard_deletes", "deletes",
         lambda: shard.shard_materialize(dels_p, m1)),
        ("shard_hostile", "hostile",
         lambda: shard.shard_materialize(hostile, m1)),
        ("sharded", "config5", lambda: mesh.sharded_materialize(adds, m1)),
        ("mesh_2d", None, lambda: mesh.batched_materialize(
            stacked4, m2, shard_ops_axis=True)),
        ("dryrun", None, lambda: dryrun_multichip(MD_DEVICES,
                                                  device=dev)),
        ("docs_axis", None, lambda: bench_docs_axis.run()),
    ]
    mods = wrapper_modules()
    errs, calls_n, per_run = {}, {}, {}
    kernels.reset_launches()
    merge.host_syncs = 0
    for name, want, fn in runs:
        s0 = dict(kernels.launches)
        f0 = merge.fallbacks
        got = []
        t0 = time.perf_counter()
        st = collectives.measure_collectives(lambda: got.append(
            capture_inputs(lambda: got.append(fn()), mods)))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        result, caught = got
        run_err = twin_errors(caught, twins)
        for kname, cases in caught.items():
            errs[kname] = max(errs.get(kname, 0.0), run_err[kname])
            calls_n[kname] = calls_n.get(kname, 0) + len(cases)
        del caught, got
        per_run[name] = {
            "ms": ms, "fallbacks": merge.fallbacks - f0,
            "collectives": {c: st[c] for c in ("count", "total_bytes")},
            "launches": {kk: kernels.launches[kk] - s0[kk] for kk in s0},
            "twin_err": run_err}
        if want is not None:
            same(table(result), ref[want], name)
        elif name == "mesh_2d":
            for i in range(MD_MESH[0]):
                same(table(mesh.doc_table(result, i)), ref4[i],
                     f"2-D mesh document {i}")
            got_fp = md_fingerprints(result).tolist()
            if got_fp != fp4:
                raise RuntimeError(f"2-D mesh fingerprints {got_fp} != "
                                   f"{fp4}")
        elif name == "dryrun":
            per_run[name]["result"] = result
        else:
            if result["num_visible"] != [N_OPS] * MD_DOCS:
                raise RuntimeError(f"bench_docs_axis: num_visible "
                                   f"{result['num_visible']}")
            res["docs_axis"] = {kk: result[kk] for kk in (
                "n_docs", "ops_per_doc", "mesh", "path", "platform",
                "batched_p50_s", "batched_agg_ops_per_s",
                "batched_compile_s", "seq_single_device_s",
                "seq_agg_ops_per_s", "batched_vs_seq")}
            # the same row when the docs axis ran its merges back to
            # back (PERF.md, section 5)
            res["docs_axis"]["batched_vs_seq_back_to_back"] = \
                DOCS_AXIS_BACK_TO_BACK
        del result
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    for name, r in per_run.items():
        want_f = 1 if name == "shard_hostile" else 0
        if r["fallbacks"] != want_f:
            raise RuntimeError(f"multidevice {name}: {r['fallbacks']} "
                               f"fallbacks, want {want_f}")
    for name in ("shard_auto", "shard_exhaustive", "shard_deletes",
                 "shard_hostile"):
        la = per_run[name]["launches"]
        if not (la["plane_rows"] and la["prefix_sums"]
                and la["monotone_gather"]):
            raise RuntimeError(f"multidevice {name}: launches {la}")
    if not (per_run["sharded"]["launches"]["ring_exclusive"]
            and per_run["mesh_2d"]["launches"]["ring_exclusive"]):
        raise RuntimeError("the ops-axis paths never launched kernel 5")
    if not per_run["docs_axis"]["launches"]["plane_rows2_batched"]:
        raise RuntimeError("bench_docs_axis never launched kernel 2's "
                           "batched form")

    # ---- the two-process leg ------------------------------------------
    t0 = time.perf_counter()
    ranks = md_join(kids, out)
    wait_s = time.perf_counter() - t0
    fps = [rk["fingerprints"] for rk in ranks]
    if any(f != fps[0] for f in fps) or len(set(fps[0])) != MD_DOCS \
            or fps[0][:MD_MESH[0]] != fp4:
        raise RuntimeError(f"multidevice fleet fingerprints disagree: "
                           f"{fps} (this process: {fp4} for docs 0-3)")
    for rk in ranks:
        for kname, e in rk["twin_err"].items():
            errs[kname] = max(errs.get(kname, 0.0), e)
        for kname, n in rk["twin_calls"].items():
            calls_n[kname] = calls_n.get(kname, 0) + n
        for kname, n in rk["launches"].items():
            launches[kname] = launches.get(kname, 0) + n
    res["fleet"] = {"processes": MD_PROCS, "backend": ranks[0]["backend"],
                    "devices": [rk["device"] for rk in ranks],
                    "fingerprints": fps[0], "join_wait_s": wait_s,
                    "launches": [rk["launches"] for rk in ranks]}
    for kname in KERNELS:
        if not launches.get(kname):
            raise RuntimeError(f"the multidevice phase never launched "
                               f"{kname}: {launches}")
    if any(errs.values()):
        raise RuntimeError(f"a kernel disagrees with its twin in the "
                           f"multidevice phase: {errs}")
    fold_errors(record, errs)

    # ---- timing: the three single-merge paths in turns ----------------
    fns = {"single": lambda: merge.materialize(adds, device=dev),
           "shard": lambda: shard.shard_materialize(adds, m1),
           "sharded": lambda: mesh.sharded_materialize(adds, m1)}
    legs = {}
    for name in ("single", "shard", "sharded", "sharded", "shard",
                 "single"):
        legs.setdefault(name, []).extend(honest.time_with_readback(
            fns[name], repeats=MD_REPEATS)["times_ms"])
    res["timing_ms"] = {n: {"p50": float(np.median(v)), "times": v}
                        for n, v in legs.items()}
    res["collectives"] = {
        "single": collectives.measure_collectives(fns["single"]),
        "shard": collectives.measure_collectives(fns["shard"]),
        "sharded": collectives.measure_collectives(fns["sharded"])}
    res.update(runs={n: {kk: v for kk, v in r.items() if kk != "twin_err"}
                     for n, r in per_run.items()},
               launches=launches, host_syncs=merge.host_syncs,
               twin_err=errs, twin_calls=calls_n)
    record["multidevice"] = res
    p50 = {n: round(v["p50"], 3) for n, v in res["timing_ms"].items()}
    log("multidevice: " + json.dumps({
        "card": card, "devices": res["devices"],
        "p50_ms": p50, "hints": "auto (verified), the three paths",
        "collectives": {n: {"count": c["count"],
                            "total_bytes": c["total_bytes"]}
                        for n, c in res["collectives"].items()},
        "docs_axis": res["docs_axis"], "fleet": {
            kk: res["fleet"][kk] for kk in ("processes", "backend",
                                            "devices", "join_wait_s")},
        "reduced": res["reduced"]}))
    log(f"multidevice: config 5 ({N_OPS} ops) through shard_materialize "
        f"(auto, exhaustive), with deletes ({dels_p['kind'].shape[0]} ops) "
        f"and hostile hints (1 fallback), and sharded_materialize at k = "
        f"{MD_DEVICES} == the single-device merge field for field; 2-D "
        f"mesh {MD_MESH[0]} x {MD_MESH[1]} slices == their merges; "
        f"dryrun_multichip({MD_DEVICES}) ok; bench_docs_axis "
        f"{MD_DOCS} x {N_OPS} all visible; {MD_PROCS} processes "
        f"({res['fleet']['backend']}) agree on {MD_DOCS} fingerprints")
    log(f"multidevice launches {launches}; every recorded kernel call held "
        f"to its twin: calls {calls_n}, max_abs_err {errs}")
    return launches


N_FLEET_DOCS = 16              # the clean leg's documents (as the mesh phase)
FLEET_NODES = ("n0", "n1", "n2")
FLEET_WRITERS, FLEET_WRITES = 24, 6    # writer sessions, writes each
                                       # (cut from 48 x 12 with the
                                       # serve phase's writers)
FLEET_LINGER_MS = 250.0        # the merge worker's linger window
FLEET_DELTA_CAP = 1 << 20      # anti-entropy window: the 1M doc in one
DEATH_DOCS = 2                 # worker-death round: documents a node
DEATH_OPS = 16_384             # and ops each: >= GRAFT_MERGETIER_MIN_OPS,
                               # and >= 1/8 of the log (the bulk route)


def fleet_phase(dev, record, twins, card):
    """The merge tier and the replica fleet on the card.  One merge
    worker (``MergeWorkerServer``, real HTTP on 127.0.0.1) owns the
    card's batched merges and registers in a ``FileKV`` pool; three
    ``FleetServer`` front-ends, each over a durable ``ServingEngine`` on
    the card (``GRAFT_WAL_SYNC=commit``), find it through the pool.

    - Clean leg: 16 documents of 65,536 chain ops (4-512 replicas) in
      one staged round over the three front-ends (their grouped runs
      ship to the worker), then config 5's 1M ops as one ``POST`` to
      n0 (a giant single).  At least one epoch carries documents of two
      or more front-ends; the worker merged every routed document; no
      rung of the fallback ladder fired; every kernel call of the
      epochs equals its twin.
    - Fleet leg: 24 writer sessions × 6 writes × 12 leaves, each sent
      to a node that is not the document's primary (forwarded); then
      anti-entropy rounds until every document's ``state_fingerprint``
      agrees on the three replicas.
    - Worker-death leg: a staged round of remote-eligible deltas (2
      documents a node) merges on the worker; the worker crashes; one
      more such round counts exactly one ``transport`` fallback per
      document and merges each on its front-end's card (kernel calls
      held to their twins).
    Then every replica's fingerprint equals a ``TpuTree`` on the card
    fed the same ops, and every acked write reads back from every
    replica.  Returns the kernel launches of the drive."""
    import os
    import random
    import shutil
    import numpy as np
    from crdt_graph_tpu_torch import engine as engine_mod, kernels
    from crdt_graph_tpu_torch.bench import workloads
    from crdt_graph_tpu_torch.cluster import FileKV, FleetServer, mergepool
    from crdt_graph_tpu_torch.cluster import kv as kv_mod
    from crdt_graph_tpu_torch.codec import json_codec, packed as packed_mod
    from crdt_graph_tpu_torch.core.operation import Add, Batch, Delete
    from crdt_graph_tpu_torch.mergetier import MergeTierClient, MergeWorker
    from crdt_graph_tpu_torch.mergetier.worker import MergeWorkerServer
    from crdt_graph_tpu_torch.obs import fleettrace, flight
    from crdt_graph_tpu_torch.serve import ServingEngine, snapshot
    from crdt_graph_tpu_torch.serve.engine import SERVER_REPLICA

    root = ROOT / "build" / "fleet"
    shutil.rmtree(root, ignore_errors=True)
    # the canary is off: its probe reads wake the peers' anti-entropy
    # daemons (a priority pull), and those background rounds would mix
    # with the rounds each leg drives and counts
    env = {"GRAFT_WAL_SYNC": "commit", "GRAFT_CANARY": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    threads_before = set(threading.enumerate())
    t_phase = time.perf_counter()
    out = {"card": card, "docs": N_FLEET_DOCS, "ops_per_doc": N_MESH,
           "writers": FLEET_WRITERS, "writes": FLEET_WRITES,
           "leaves": N_LEAVES, "linger_ms": FLEET_LINGER_MS}
    ws = keeper = None
    fleet = {}
    try:
        kv = FileKV(str(root / "kv"))
        ws = MergeWorkerServer(MergeWorker(
            linger_ms=FLEET_LINGER_MS, max_width=N_FLEET_DOCS, name="w0"))
        if ws.worker.device != dev:
            raise RuntimeError(f"merge worker on {ws.worker.device}")
        keeper = mergepool.MergePoolKeeper(kv, "w0", ws.addr).start()
        # each epoch's riders: (document, the front-end that sent it)
        epochs = []
        launch = ws.worker.batcher._launch

        def spy(cargo):
            epochs.append([(m["doc_id"], (fleettrace.parse_span_ctx(
                (m.get("trace") or {}).get("span_ctx")) or ("?",))[0])
                for _, m in cargo])
            return launch(cargo)
        ws.worker.batcher._launch = spy
        for n in FLEET_NODES:
            mt = MergeTierClient.from_env(src=n, kv=kv)
            if mt is None:
                raise RuntimeError("the pool lists no merge worker")
            eng = ServingEngine(durable_dir=str(root / n), mergetier=mt,
                                flight=flight.FlightRecorder())
            if eng.device != dev:
                raise RuntimeError(f"{n}'s engine on {eng.device}")
            fleet[n] = FleetServer(n, kv, engine=eng, ttl_s=600.0,
                                   ae_interval_s=3600.0,
                                   delta_cap=FLEET_DELTA_CAP)
        for fs in fleet.values():
            fs.node.refresh_ring()
        ring = fleet["n0"].node.ring()
        port = {n: fs.port for n, fs in fleet.items()}
        engines = {n: fs.node.engine for n, fs in fleet.items()}
        docs = [f"m{i}" for i in range(N_FLEET_DOCS)]
        big = next(f"c5-{i}" for i in range(500)
                   if ring.primary(f"c5-{i}") == "n0")
        primary = {d: ring.primary(d) for d in docs + [big]}
        if set(primary[d] for d in docs) != set(FLEET_NODES):
            raise RuntimeError(f"documents not spread: {primary}")
        sent = {d: [] for d in docs + [big]}    # every acked body, in order
        n_rep = {}
        for i, d in enumerate(docs):
            n_rep[d] = 4 << (i % 8)
            p = packed_chain(workloads.chain_workload(n_rep[d], N_MESH),
                             N_MESH)
            sent[d].append(packed_mod.packed_since_bytes(p, 0))
        n_rep[big] = N_REPLICAS
        sent[big].append(packed_mod.packed_since_bytes(
            packed_chain(workloads.chain_workload(N_REPLICAS, N_OPS), N_OPS),
            0))
        # the bootstrap's replicas hold their fleet-unique ids first (the
        # counter /docs/{id}/replicas allocates from), so a writer's id
        # never collides with a bootstrap replica's timestamps
        for d, r in n_rep.items():
            for _ in range(r):
                kv_mod.next_counter(kv, f"replica/{d}")

        def push(d, body, n_ops):
            cl = Client(port[primary[d]], timeout=600.0)
            t0 = time.perf_counter()
            a = cl.json("POST", f"/docs/{d}/ops", body=body)
            cl.close()
            if not a["accepted"] or a["applied_count"] != n_ops:
                raise RuntimeError(f"{d} push ack {a}")
            return (time.perf_counter() - t0) * 1e3

        def staged(pushes):
            """One scheduler round on every node: the pushes queue on
            their primaries with the schedulers paused, then all
            resume together."""
            for e in engines.values():
                e.scheduler.pause()
            ths = [Worker(f"push-{d}", fn) for d, fn in pushes.items()]
            for t in ths:
                t.start()
            deadline = time.monotonic() + CALL_S
            while sum(len(engines[primary[d]].get(d).queue)
                      for d in pushes) < len(pushes):
                if time.monotonic() > deadline or any(
                        t.error for t in ths):
                    raise RuntimeError("staged pushes never queued")
                time.sleep(0.005)
            for e in engines.values():
                e.scheduler.resume()
            for t in ths:
                t.join(600.0)
                if t.is_alive() or t.error:
                    raise RuntimeError(f"{t.name}: {t.error!r}")

        def tier():
            """(remote docs, remote ops, fallbacks by rung) summed over
            the front-ends."""
            rd, ro, fb = 0, 0, {}
            for e in engines.values():
                st = e.mergetier.stats()
                rd += st["remote_docs"]
                ro += st["remote_ops"]
                for k, v in st["fallbacks"].items():
                    fb[k] = fb.get(k, 0) + v
            return rd, ro, fb

        kernels.reset_launches()

        # ---- clean leg --------------------------------------------------
        def clean_leg():
            t0 = time.perf_counter()
            staged({d: (lambda d=d: push(d, sent[d][0], N_MESH))
                    for d in docs})
            out["staged_round_s"] = time.perf_counter() - t0
            out["giant_commit_ms"] = push(big, sent[big][0], N_OPS)

        caught = capture_inputs(clean_leg, wrapper_modules())
        errs = twin_errors(caught, twins)
        for k in BATCHED_JOIN:
            if k not in errs:
                raise RuntimeError(f"the worker's epochs never called {k}")
        if any(e != 0 for e in errs.values()):
            raise RuntimeError(f"epoch kernel calls differ: {errs}")
        fold_errors(record, errs)
        out["epoch_twin_calls"] = {k: len(v) for k, v in caught.items()}
        del caught
        routed, routed_ops, fallbacks = tier()
        wst = ws.worker.stats()
        mixed = [e for e in epochs
                 if len(e) >= 2 and len({src for _, src in e}) >= 2]
        out["clean"] = {
            "epochs": len(epochs), "widths": [len(e) for e in epochs],
            "cross_frontend_epochs": len(mixed),
            "routed_docs": routed, "routed_ops": routed_ops,
            "merged_docs": wst["merged_docs"], "fallbacks": fallbacks}
        if routed != N_FLEET_DOCS + 1 or wst["merged_docs"] != routed:
            raise RuntimeError(f"clean leg routed {routed}, worker "
                               f"merged {wst['merged_docs']}")
        if fallbacks or any(e.counters.get("mergetier_fallbacks")
                            for e in engines.values()):
            raise RuntimeError(f"clean leg fell back: {fallbacks}")
        if not mixed:
            raise RuntimeError(f"no epoch drew riders from two front-ends: "
                               f"{epochs}")
        if [big] not in [[d for d, _ in e] for e in epochs]:
            raise RuntimeError("the 1M-op POST did not ship as one rider")
        log(f"fleet: clean leg: {len(epochs)} epochs of widths "
            f"{out['clean']['widths']}, {len(mixed)} drawn from two or more "
            f"front-ends; {routed} documents ({routed_ops} ops) routed, "
            f"{wst['merged_docs']} merged by the worker, no fallback; "
            f"{out['epoch_twin_calls']} kernel calls == twins; staged "
            f"round {out['staged_round_s']:.2f} s, 1M-op POST acked in "
            f"{out['giant_commit_ms']:.1f} ms")

        # ---- fleet leg: forwarded writers, then anti-entropy ------------
        def writer(idx):
            doc = docs[idx % N_FLEET_DOCS]
            owner = primary[doc]
            entry = FLEET_NODES[(FLEET_NODES.index(owner) + 1 + idx % 2)
                                % len(FLEET_NODES)]
            cl = Client(port[entry])
            rid = cl.json("POST", f"/docs/{doc}/replicas")["replica"]
            rng = random.Random(3000 + idx)
            alive, gone, ms, bodies, counter = [], [], [], [], 0
            for w in range(FLEET_WRITES):
                ops = []
                for _ in range(N_LEAVES):
                    if alive and rng.random() < BACKSPACE_P:
                        ts, v = alive.pop()
                        ops.append(Delete((ts,)))
                        gone.append(v)
                    else:
                        counter += 1
                        ts = rid * 2**32 + counter
                        ops.append(Add(ts, (alive[-1][0] if alive else 0,),
                                       f"f{idx}.{counter}"))
                        alive.append((ts, f"f{idx}.{counter}"))
                body = json_codec.dumps(Batch(tuple(ops))).encode()
                while True:
                    t0 = time.perf_counter()
                    st, raw, _ = cl.call("POST", f"/docs/{doc}/ops",
                                         body=body)
                    if st not in (429, 503):
                        break
                    time.sleep(0.05)
                ms.append((time.perf_counter() - t0) * 1e3)
                a = json.loads(raw)
                if st != 200 or not a["accepted"] \
                        or a["applied_count"] != N_LEAVES \
                        or a["served_by"]["name"] != owner:
                    raise RuntimeError(f"{doc} write {w} via {entry} -> "
                                       f"{st} {a}")
                bodies.append(body)
            cl.close()
            return doc, [v for _, v in alive], gone, ms, bodies

        writers = [Worker(f"writer-{i}", lambda i=i: writer(i))
                   for i in range(FLEET_WRITERS)]
        t0 = time.perf_counter()
        run_threads(writers, 600.0)
        out["writer_wall_s"] = time.perf_counter() - t0
        for t in writers:
            sent[t.result[0]].extend(t.result[4])
        acked_ms = [m for t in writers for m in t.result[3]]
        out["acked_write_p50_ms"] = float(np.percentile(acked_ms, 50))
        out["acked_write_p99_ms"] = float(np.percentile(acked_ms, 99))
        out["forwards"] = sum(fs.node.counters["forwarded_ok"]
                              for fs in fleet.values())
        if out["forwards"] < FLEET_WRITERS * FLEET_WRITES:
            raise RuntimeError(f"only {out['forwards']} forwards")

        def fingerprints(d):
            got = {}
            for n, e in engines.items():
                doc = e.get(d, create=False)
                got[n] = None if doc is None \
                    else doc.read_view().state_fingerprint()
            return got

        def converge(tag):
            t0 = time.perf_counter()
            for rounds in range(1, 11):
                run_threads([Worker(f"ae-{n}", fs.node.antientropy.sync_now)
                             for n, fs in fleet.items()], 600.0)
                split = {d: f for d in docs + [big]
                         if len(set((f := fingerprints(d)).values())) != 1}
                if not split:
                    out[f"{tag}_converge_s"] = time.perf_counter() - t0
                    out[f"{tag}_converge_rounds"] = rounds
                    return
            raise RuntimeError(f"{tag}: no convergence: {split}")

        converge("fleet")
        out["fleet_fallbacks"] = tier()[2]
        ae = [r for e in engines.values() for r in e.flight.records()
              if r.outcome in ("committed", "partial")
              and any(t.startswith("ae-") for t in r.trace_ids)]
        out["ae_commits"] = len(ae)
        out["ae_commit_stage_p50_ms"] = {
            k: float(np.percentile([r.stages_ms[k] for r in ae
                                    if k in r.stages_ms], 50))
            for k in sorted({k for r in ae for k in r.stages_ms})}
        out["ae_commit_total_ms"] = float(sum(r.total_ms for r in ae))
        log(f"fleet: {FLEET_WRITERS} writers x {FLEET_WRITES} writes acked "
            f"in {out['writer_wall_s']:.1f} s through {out['forwards']} "
            f"forwards (p50 {out['acked_write_p50_ms']:.1f} ms, p99 "
            f"{out['acked_write_p99_ms']:.1f} ms); anti-entropy converged "
            f"every document in {out['fleet_converge_rounds']} rounds, "
            f"{out['fleet_converge_s']:.1f} s ({out['ae_commits']} commits "
            f"of pulled windows, {out['ae_commit_total_ms']:.0f} ms in all, "
            f"p50 stage ms {out['ae_commit_stage_p50_ms']}; fallbacks "
            f"{out['fleet_fallbacks']})")

        # ---- worker-death leg -------------------------------------------
        # a healthy remote round first: its successes close every
        # front-end's breaker streak (the fleet leg may end on failed
        # attempts), so the round after the crash meets the transport
        # rung, not an open breaker
        death = [d for n in FLEET_NODES
                 for d in [x for x in docs if primary[x] == n][:DEATH_DOCS]]
        drid = {}

        def delta_round():
            rids = {d: kv_mod.next_counter(kv, f"replica/{d}")
                    for d in death}
            bodies = {d: json_codec.dumps(Batch(tuple(
                Add(r * 2**32 + c, ((r * 2**32 + c - 1) if c > 1 else 0,),
                    f"x{r}.{c}") for c in range(1, DEATH_OPS + 1)))).encode()
                for d, r in rids.items()}
            staged({d: (lambda d=d: push(d, bodies[d], DEATH_OPS))
                    for d in death})
            for d in death:
                sent[d].append(bodies[d])
                drid.setdefault(d, []).append(rids[d])

        routed0, _, fb0 = tier()
        delta_round()
        routed1, _, fb1 = tier()
        if routed1 - routed0 != len(death) or fb1 != fb0:
            raise RuntimeError(f"the healthy round routed "
                               f"{routed1 - routed0}, fallbacks {fb1}")
        if any(w.fail_streak for e in engines.values()
               for w in e.mergetier.workers):
            raise RuntimeError("a breaker streak outlived the healthy "
                               "round")
        ws.crash()
        fb_counter0 = sum(e.counters.get("mergetier_fallbacks")
                          for e in engines.values())
        kernels_before = dict(kernels.launches)
        caught = capture_inputs(delta_round, wrapper_modules())
        local = {k: kernels.launches.get(k, 0) - kernels_before.get(k, 0)
                 for k in kernels.launches}
        errs = twin_errors(caught, twins)
        if not errs or any(e != 0 for e in errs.values()):
            raise RuntimeError(f"fallback merges' kernel calls: {errs}")
        fold_errors(record, errs)
        routed2, _, fb2 = tier()
        new_fb = {k: fb2.get(k, 0) - fb1.get(k, 0) for k in fb2
                  if fb2.get(k, 0) != fb1.get(k, 0)}
        fb_counter = sum(e.counters.get("mergetier_fallbacks")
                         for e in engines.values()) - fb_counter0
        out["death"] = {"docs": len(death), "fallbacks": new_fb,
                        "local_launches": local,
                        "twin_calls": {k: len(v) for k, v in caught.items()}}
        del caught
        if new_fb != {"transport": len(death)} or routed2 != routed1 \
                or fb_counter != len(death):
            raise RuntimeError(f"worker death: fallbacks {new_fb}, routed "
                               f"{routed2 - routed1}, counted {fb_counter}")
        if sum(local.values()) < 1:
            raise RuntimeError("the fallback merges launched no kernel")
        converge("death")
        launches = dict(kernels.launches)
        log(f"fleet: worker crashed; {len(death)} routed documents fell "
            f"back {new_fb}, merged on their front-ends' card "
            f"({out['death']['twin_calls']} kernel calls == twins); "
            f"converged again in {out['death_converge_s']:.1f} s")

        # ---- what the fleet serves --------------------------------------
        t0 = time.perf_counter()
        for d in docs + [big]:
            tree = engine_mod.init(SERVER_REPLICA, device=dev)
            for body in sent[d]:
                tree.apply_wire(body)
            want = snapshot.derive(d, 0, tree).state_fingerprint()
            got = fingerprints(d)
            if set(got.values()) != {want}:
                raise RuntimeError(f"{d}: replicas {got} != a TpuTree on "
                                   f"the card fed the same ops ({want})")
            served = {}
            for n in FLEET_NODES:
                c = Client(port[n], timeout=600.0)
                st, raw, r = c.call("GET", f"/docs/{d}")
                c.close()
                if st != 200 or r.getheader("X-State-Fingerprint") != want:
                    raise RuntimeError(f"GET {d} on {n} -> {st}")
                served[n] = json.loads(raw)["values"]
            for t in writers:
                doc, alive, gone, _, _ = t.result
                if doc != d:
                    continue
                for n, vals in served.items():
                    pos = {v: i for i, v in enumerate(vals)
                           if isinstance(v, str)}
                    got_pos = [pos.get(v) for v in alive]
                    if None in got_pos or got_pos != sorted(got_pos) or \
                            any(v in pos for v in gone):
                        raise RuntimeError(f"{t.name}'s acked writes do "
                                           f"not read back on {n}")
            for r in drid.get(d, ()):
                for n, vals in served.items():
                    if sum(1 for v in vals if str(v).startswith(
                            f"x{r}.")) != DEATH_OPS:
                        raise RuntimeError(f"{d}: the delta of replica "
                                           f"{r} is not on {n}")
            del tree
        out["verify_s"] = time.perf_counter() - t0

        records = [r for e in engines.values() for r in e.flight.records()]
        out["flight_audit"] = flight_audits(
            [e.flight for e in engines.values()], "fleet")

        def p50(key):
            v = [r.stages_ms[key] for r in records if key in r.stages_ms]
            return float(np.percentile(v, 50)) if v else None

        out.update({
            "epochs": len(epochs),
            "width_hist": ws.worker.width_hist.export(),
            "routed_docs": tier()[0], "routed_ops": tier()[1],
            "fallbacks": tier()[2],
            "ae_rounds": sum(fs.node.antientropy.stats()["rounds"]
                             for fs in fleet.values()),
            "remote_transport_p50_ms": p50("remote_transport"),
            "remote_queue_p50_ms": p50("remote_queue"),
            "remote_launch_p50_ms": p50("remote_launch"),
            "launches": launches})
    finally:
        for fs in fleet.values():
            fs.stop()
        if keeper is not None:
            keeper.stop()
        if ws is not None and not ws.worker.stats()["dead"]:
            ws.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    deadline = time.monotonic() + 30
    while True:
        left = [t.name for t in set(threading.enumerate()) - threads_before
                if t.is_alive()]
        if not left:
            break
        if time.monotonic() > deadline:
            raise RuntimeError(f"the fleet left threads running: {left}")
        time.sleep(0.1)
    shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    record["fleet"] = out
    log("fleet: " + json.dumps({
        "card": card, "epochs": out["epochs"],
        "width_hist": out["width_hist"],
        "cross_frontend_epochs": out["clean"]["cross_frontend_epochs"],
        "routed_docs": out["routed_docs"], "routed_ops": out["routed_ops"],
        "fallbacks": out["fallbacks"],
        "fleet_leg_fallbacks": out["fleet_fallbacks"],
        "death_leg_fallbacks": out["death"]["fallbacks"],
        "forwards": out["forwards"],
        "ae_rounds": out["ae_rounds"],
        "converge_s": round(out["fleet_converge_s"], 3),
        "remote_transport_p50_ms": out["remote_transport_p50_ms"],
        "remote_queue_p50_ms": out["remote_queue_p50_ms"],
        "remote_launch_p50_ms": out["remote_launch_p50_ms"],
        "acked_write_p50_ms": round(out["acked_write_p50_ms"], 3),
        "acked_write_p99_ms": round(out["acked_write_p99_ms"], 3),
        "flight_audit": out["flight_audit"],
        "phase_s": round(out["phase_s"], 1), "launches": out["launches"]}))
    return out["launches"]


BENCH_EDIT_SIZES = (1_000, 10_000, 100_000)     # incremental.run documents
BENCH_EDITS = 1_000                             # edits on each
BENCH_BULK_SIZES = (10_000, 100_000, 1_000_000)  # incremental.run_bulk
BENCH_BULK_DELTAS = (1_000, 10_000)
BENCH_SERVE = (4, 5.0, 100_000)     # serving.run: docs, seconds, bootstrap
LOADGEN_SHAPE = dict(n_sessions=64, writes_per_session=12, delta_size=12,
                     n_docs=4, n_watchers=8, giant_ops=262_144)


def bench_phase(dev, record, twins, card):
    """The port's benches on the card, each through its own entry point
    with no ``device=`` (the card is the default):

    - ``bench.runner.run`` over configs 1-8 at their full
      ``workloads.CONFIGS`` sizes (``hints=None``), and
      ``runner.headline()`` (config 5, exhaustive): every row
      order-exact with its timing audit ok;
    - ``bench.incremental.run`` (editor per-op latency on seeded
      documents of 1k, 10k and 100k characters, 1,000 edits each) and
      ``run_bulk`` (deltas of 1k and 10k on 10k, 100k and 1M);
    - ``bench.serving.run`` (4 documents, 5 s, a 100k-op bootstrap);
    - ``bench.loadgen.run`` against a durable server: 64 sessions × 12
      writes × 12 leaves over 4 documents, 8 watchers and a 262,144-op
      giant racer; zero oracle violations, no errors, every acked leaf
      merged, a coalesced commit of width >= 2.

    ``bench.loadgen.run_fleet`` is driven by the headline phase's
    ``bench_fleet_headline`` (three servers, a kill, every document
    converged), not here.

    Every kernel call of the benches is recorded and held to its twin
    afterwards (a device copy of its arguments and result; nothing runs
    twice).  The runner's timed repeats are not recorded, so that no
    copy is timed: the first, untimed call of each row's timed function
    is, on the same inputs.  Returns the kernel launches of the drive."""
    import contextlib
    import io
    import shutil
    from crdt_graph_tpu_torch import kernels
    from crdt_graph_tpu_torch.bench import incremental, loadgen, runner, \
        serving
    from crdt_graph_tpu_torch.obs import flight
    from crdt_graph_tpu_torch.serve import ServingEngine

    root = ROOT / "build" / "bench"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t_phase = time.perf_counter()
    out = {"card": card, "twin_calls": {}, "bench_s": {}}
    errs_all = {}

    def checked(name, fn):
        """Run ``fn`` with every kernel call recorded; hold each call to
        its twin; keep the bench's seconds and return its result."""
        got = {}
        t0 = time.perf_counter()
        # the benches print their own rows; the phase logs them as
        # ``bench:`` lines instead
        with contextlib.redirect_stdout(io.StringIO()):
            caught = capture_inputs(lambda: got.setdefault("r", fn()),
                                    wrapper_modules())
        out["bench_s"][name] = out["bench_s"].get(name, 0.0) + \
            time.perf_counter() - t0
        errs = twin_errors(caught, twins)
        for k, e in errs.items():
            errs_all[k] = max(errs_all.get(k, 0.0), e)
        calls = {k: len(v) for k, v in caught.items()}
        for k, n in calls.items():
            out["twin_calls"][k] = out["twin_calls"].get(k, 0) + n
        del caught
        if any(e != 0 for e in errs.values()):
            raise RuntimeError(f"{name}: kernel calls differ from their "
                               f"twins: {errs}")
        return got["r"]

    # the runner: the first call of each row's timed function recorded
    summary = runner._summary_fn

    def first_call_recorded(*a, **kw):
        fn = summary(*a, **kw)
        calls = []

        def once(*args):
            calls.append(1)
            if len(calls) > 1:
                return fn(*args)
            return checked("runner_first_calls", lambda: fn(*args))
        return once

    kernels.reset_launches()
    runner._summary_fn = first_call_recorded
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            rows = runner.run()
            out["bench_s"]["runner"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            head = runner.headline()
            out["bench_s"]["headline"] = time.perf_counter() - t0
    finally:
        runner._summary_fn = summary
    for row in rows + [head]:
        log("bench: " + json.dumps(dict(row, card=card)))
    bad = [r["config"] for r in rows if r["order_check"] != "exact"
           or not r["audit"]["ok"]]
    if bad or not head["audit"]["ok"]:
        raise RuntimeError(f"runner rows not order-exact or audit failed: "
                           f"{bad} {head['audit']}")
    # the trace audit's keys, with no error (the runner keeps a failed
    # audit as an ``error`` to keep the row; here it fails the phase)
    bad = {r["config"]: (r.get("chain_audit"), r.get("opsaxis"))
           for r in rows if "error" in r.get("chain_audit", {"error": 0})
           or "error" in r.get("opsaxis", {"error": 0})}
    if bad:
        raise RuntimeError(f"runner rows' trace audits: {bad}")
    out["runner"] = rows
    out["headline"] = head

    edit_rows = checked("incremental", lambda: incremental.run(
        BENCH_EDIT_SIZES, BENCH_EDITS))
    bulk_rows = checked("incremental_bulk", lambda: incremental.run_bulk(
        BENCH_BULK_SIZES, BENCH_BULK_DELTAS))
    for row in edit_rows + bulk_rows:
        log("bench: " + json.dumps(dict(row, card=card)))
    out["incremental"], out["bulk"] = edit_rows, bulk_rows

    n_docs, secs, boot = BENCH_SERVE
    srv = checked("serving", lambda: serving.run(
        n_docs=n_docs, seconds=secs, bootstrap_ops=boot))
    if srv["errors"]:
        raise RuntimeError(f"serving: {srv['errors']}")
    out["serving"] = {k: srv[k] for k in (
        "docs", "writers", "readers", "wall_s", "ops_merged",
        "merge_ops_per_sec", "reads", "read_p50_ms", "read_p99_ms",
        "read_max_ms", "bootstrap_ops", "bootstrap_commit_s", "device")}
    log("bench: " + json.dumps(dict(out["serving"], bench="serving",
                                    card=card)))

    cfg = loadgen.LoadgenConfig(seed=8, **LOADGEN_SHAPE)
    eng = ServingEngine(durable_dir=str(root / "serve"),
                        max_queue_requests=cfg.max_queue_requests,
                        flight=flight.FlightRecorder(capacity=8192))
    if eng.device != dev:
        raise RuntimeError(f"the loadgen engine on {eng.device}")
    try:
        rep = checked("loadgen", lambda: loadgen.run(cfg, engine=eng))
    finally:
        eng.close()
    head_keys = ("sessions", "docs", "writes_acked", "leaves_acked",
                 "ops_merged", "load_wall_s", "ops_per_sec", "reads",
                 "read_p50_ms", "read_p99_ms", "ack_p50_ms", "ack_p99_ms",
                 "shed_429", "giant_ops", "giant_commit_s", "wal_sync",
                 "staged_first_round")
    out["loadgen"] = {k: rep[k] for k in head_keys}
    out["loadgen"].update(
        violations=len(rep["violations"]), errors=rep["errors"],
        max_coalesce_width=rep["oracle"]["max_coalesce_width"],
        watch={k: rep["watch"][k] for k in (
            "watchers", "deliveries", "notifies", "heartbeats")},
        ack_breakdown_ms=rep["ack_breakdown_ms"],
        flight_audit=flight_audits([eng.flight], "loadgen"))
    log("bench: " + json.dumps(dict(out["loadgen"], bench="loadgen",
                                    card=card)))
    if rep["errors"] or rep["violations"] or \
            rep["oracle"]["violations_total"]:
        raise RuntimeError(f"loadgen: errors {rep['errors']}, violations "
                           f"{rep['violations'][:4]}")
    if rep["ops_merged"] != rep["leaves_acked"]:
        raise RuntimeError(f"loadgen: {rep['ops_merged']} ops merged, "
                           f"{rep['leaves_acked']} leaves acked")
    if rep["oracle"]["max_coalesce_width"] < 2:
        raise RuntimeError("loadgen: no coalesced commit of width >= 2")

    launches = dict(kernels.launches)
    for k in MERGE_KERNELS:
        if launches[k] < 1:
            raise RuntimeError(f"the bench phase never launched {k}")
    fold_errors(record, errs_all)
    shutil.rmtree(root, ignore_errors=True)
    out["launches"] = launches
    out["twin_err"] = errs_all
    out["phase_s"] = time.perf_counter() - t_phase
    record["bench"] = out
    log("bench: " + json.dumps({
        "card": card, "phase_s": round(out["phase_s"], 1),
        "bench_s": {k: round(v, 2) for k, v in out["bench_s"].items()},
        "launches": launches, "twin_calls": out["twin_calls"],
        "twin_max_abs_err": errs_all}))
    return launches


W_DOCS = 64                    # documents the walshared phase hosts
W_CRASH_SITE = "post-fsync-pre-publish"


def prom_total(fams, name):
    """The sum of a counter family's samples (0 when it is absent)."""
    fam = fams.get(name)
    return sum(s[2] for s in fam["samples"]) if fam else 0.0


def wal_counts(c):
    """The WAL counters of a served engine, read from ``/metrics/prom``:
    fsyncs (the shared stream's, or the sum of the documents' own),
    group-commit rounds of the sync lane, commits it resolved, and the
    shared stream's rounds and covered documents."""
    from crdt_graph_tpu_torch.obs import prom
    fams = prom.parse_text(c.call("GET", "/metrics/prom")[1].decode())
    shared = "crdt_wal_shared_fsyncs_total" in fams
    return {
        "shared": shared,
        "fsyncs": prom_total(fams, "crdt_wal_shared_fsyncs_total"
                             if shared else "crdt_wal_fsyncs_total"),
        "rounds": prom_total(fams, "crdt_sched_pipeline_rounds_total"),
        "commits": prom_total(fams,
                              "crdt_sched_pipeline_commits_synced_total"),
        "shared_rounds": prom_total(
            fams, "crdt_scheduler_wal_shared_rounds_total"),
        "shared_covered": prom_total(
            fams, "crdt_scheduler_wal_shared_covered_docs_total")}


def wal_delta(before, after):
    """Counters over a window, with fsyncs a round and commits (shared:
    covered documents) a fsync."""
    d = {k: after[k] - before[k] for k in after if k != "shared"}
    d["fsyncs_per_round"] = d["fsyncs"] / max(d["rounds"], 1)
    d["commits_per_fsync"] = (d["shared_covered"] if after["shared"]
                              else d["commits"]) / max(d["fsyncs"], 1)
    return d


def wal_load(root, shared, wire, twins, record):
    """The walshared phase's load on one durable ``ServingEngine`` on the
    card (WAL sync ``batch``, the shared stream or a WAL a document)
    behind the HTTP server: document 0 by one ``POST`` of config 5
    (``wire``), 63 documents by one staged round of 4,096-op chains (its
    kernel calls held to their twins when ``twins`` is given), then one
    writer session a document while 8 readers read.  Returns ``(srv, th, out,
    writers)`` with the server still up."""
    import numpy as np
    from crdt_graph_tpu_torch.codec import json_codec
    from crdt_graph_tpu_torch.core.operation import Add, Batch
    from crdt_graph_tpu_torch.serve import ServingEngine
    from crdt_graph_tpu_torch.service import make_server

    eng = ServingEngine(durable_dir=str(root), wal_sync="batch",
                        wal_shared=shared, submit_timeout_s=CALL_S)
    if (eng.shared_wal is not None) != shared:
        raise RuntimeError(f"wal_shared={shared} built {eng.shared_wal}")
    srv = make_server(port=0, store=eng)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_port
    c = Client(port, timeout=600.0)
    out = {"mode": "shared" if shared else "per-doc", "docs": W_DOCS}
    for _ in range(N_REPLICAS):            # config 5's replica ids
        c.json("POST", "/docs/d0/replicas")
    t0 = time.perf_counter()
    ack = c.json("POST", "/docs/d0/ops", body=wire)
    out["giant_commit_ms"] = (time.perf_counter() - t0) * 1e3
    if ack["applied_count"] != N_OPS:
        raise RuntimeError(f"d0 bootstrap ack {ack}")

    def bootstrap(k):
        cl = Client(port)
        rid = cl.json("POST", f"/docs/d{k}/replicas")["replica"]
        ops = [Add(rid * 2**32 + i, ((rid * 2**32 + i - 1) if i > 1
                                     else 0,), f"b{k}.{i}")
               for i in range(1, N_STAGED + 1)]
        a = cl.json("POST", f"/docs/d{k}/ops",
                    body=json_codec.dumps(Batch(tuple(ops))))
        cl.close()
        if a["applied_count"] != N_STAGED:
            raise RuntimeError(f"d{k} bootstrap ack {a}")

    for k in range(1, W_DOCS):
        eng.get(f"d{k}")
    eng.scheduler.pause()
    boots = [Worker(f"boot-d{k}", lambda k=k: bootstrap(k))
             for k in range(1, W_DOCS)]

    def staged_round():
        for t in boots:
            t.start()
        deadline = time.monotonic() + CALL_S
        while sum(len(eng.get(f"d{k}").queue)
                  for k in range(1, W_DOCS)) < W_DOCS - 1:
            if time.monotonic() > deadline or any(t.error for t in boots):
                raise RuntimeError("staged pushes never queued")
            time.sleep(0.005)
        eng.scheduler.resume()
        for t in boots:
            t.join(CALL_S)
        if not eng.flush(CALL_S):
            raise RuntimeError("staged round never flushed")

    before = wal_counts(c)
    if twins is None:
        staged_round()
    else:
        caught = capture_inputs(staged_round, wrapper_modules())
        errs = twin_errors(caught, twins)
        if any(e != 0 for e in errs.values()):
            raise RuntimeError(f"staged-round kernel calls differ: {errs}")
        fold_errors(record, errs)
        out["staged_twin_calls"] = {k: len(v) for k, v in caught.items()}
        del caught
    for t in boots:
        if t.is_alive() or t.error:
            raise RuntimeError(f"{t.name}: {t.error!r}")
    out["staged_round"] = wal_delta(before, wal_counts(c))

    stop_reads = threading.Event()

    def reader(idx):
        cl = Client(port)
        ms, i = [], 0
        since = N_REPLICAS * 2**32 + 15_000
        while not stop_reads.is_set():
            k = (idx * 8 + i) % W_DOCS
            i += 1
            path = (f"/docs/d0/ops?since={since}&limit=256"
                    if k == 0 else f"/docs/d{k}")
            t0 = time.perf_counter()
            st, _, _ = cl.call("GET", path)
            ms.append((time.perf_counter() - t0) * 1e3)
            if st != 200:
                raise RuntimeError(f"read {path} -> {st}")
        cl.close()
        return ms

    writers = [Worker(f"writer-{i}",
                      lambda i=i: write_session(port, f"d{i}", i))
               for i in range(W_DOCS)]
    readers = [Worker(f"reader-{i}", lambda i=i: reader(i))
               for i in range(N_READERS)]
    before = wal_counts(c)
    for t in readers:
        t.start()
    t0 = time.perf_counter()
    try:
        run_threads(writers, 600.0)
    finally:
        out["writer_wall_s"] = time.perf_counter() - t0
        stop_reads.set()
        for t in readers:
            t.join(CALL_S)
    for t in readers:
        if t.is_alive() or t.error:
            raise RuntimeError(f"{t.name}: {t.error!r}")
    if not eng.flush(CALL_S):
        raise RuntimeError("the served engine never flushed")
    out["load"] = wal_delta(before, wal_counts(c))
    ack_ms = [m for t in writers for m in t.result[3]]
    read_ms = [m for t in readers for m in t.result]
    out.update({
        "acked_writes": len(ack_ms),
        "ack_p50_ms": float(np.percentile(ack_ms, 50)),
        "ack_p99_ms": float(np.percentile(ack_ms, 99)),
        "reads": len(read_ms),
        "read_p50_ms": float(np.percentile(read_ms, 50))})
    c.close()
    return srv, th, out, writers


def check_wal_docs(eng, writers, fps=None):
    """Every document of a walshared engine serves its writer's acked
    writes, document 0 config 5's 1M values in closed-form order ahead
    of them, documents 1-63 their bootstraps; with ``fps``, each
    document's ``state_fingerprint`` equals the one given.  Returns
    {doc: state_fingerprint}."""
    import numpy as np
    from crdt_graph_tpu_torch.bench import workloads
    exp_ts = workloads.chain_expected_ts(N_REPLICAS, N_OPS)
    per = N_OPS // N_REPLICAS
    exp_rows = ((exp_ts >> 32) - 1) * per + (exp_ts & 0xFFFFFFFF) - 1
    out = {}
    for t in writers:
        doc = t.result[0]
        served = eng.get(doc, create=False)
        if served is None:
            raise RuntimeError(f"{doc} is not served")
        snap = served.read_view()
        vals = list(snap.values)
        if not acked_read_back(vals, t.result):
            raise RuntimeError(f"{t.name}'s acked writes do not read "
                               f"back on {doc}")
        if doc == "d0":
            ints = np.array([v for v in vals if isinstance(v, int)])
            if not np.array_equal(ints, exp_rows):
                raise RuntimeError("d0 does not hold config 5's 1M "
                                   "values in closed-form order")
        elif sum(1 for v in vals if str(v).startswith(
                f"b{doc[1:]}.")) != N_STAGED:
            raise RuntimeError(f"{doc} lost its bootstrap")
        out[doc] = snap.state_fingerprint()
        if fps is not None and out[doc] != fps[doc]:
            raise RuntimeError(f"{doc}: state_fingerprint changed over "
                               f"the crash")
    return out


def walshared_phase(dev, record, twins, card):
    """The shared group-commit WAL on the card.  A durable
    ``ServingEngine`` with ``wal_sync="batch"`` and ``wal_shared=True``,
    behind the HTTP server, hosts 64 documents: document 0 bootstraps
    by one ``POST`` of config 5 (1M ops, 64 replicas) as wire JSON,
    documents 1-63 by one staged round of 4,096-op chains (every kernel
    call held to its twin), then 64 writer sessions of 24 12-leaf deltas,
    one a document, while 8 readers read.  Fsyncs a round, covered
    documents a fsync and ack p50/p99 come from ``/metrics/prom`` and
    the writers.  The server is then killed in process at
    ``post-fsync-pre-publish`` on one more write and a fresh engine
    recovers the directory on the card: every acked write reads back,
    every document keeps its ``state_fingerprint``, document 0 its 1M
    values, and the killed write (fsynced, never acked) is recovered.
    The same load runs once more with a WAL a document, for the same
    numbers beside them.  Returns the kernel launches of the phase."""
    import os
    import shutil
    from crdt_graph_tpu_torch import kernels
    from crdt_graph_tpu_torch.bench import workloads
    from crdt_graph_tpu_torch.codec import json_codec, packed as packed_mod
    from crdt_graph_tpu_torch.core.operation import Add, Batch
    from crdt_graph_tpu_torch.serve import ServingEngine

    root = ROOT / "build" / "walshared"
    shutil.rmtree(root, ignore_errors=True)
    t_phase = time.perf_counter()
    out = {"card": card}
    try:
        wire = packed_mod.packed_since_bytes(packed_chain(
            workloads.chain_workload(N_REPLICAS, N_OPS), N_OPS), 0)
        kernels.reset_launches()
        # ---- the shared stream ------------------------------------------
        srv, th, shared, writers = wal_load(root / "shared", True, wire,
                                            twins, record)
        eng = srv.store
        load = shared["load"]
        if shared["staged_round"]["fsyncs"] != 1 or \
                shared["staged_round"]["shared_covered"] != W_DOCS - 1:
            raise RuntimeError(f"the staged round's 63 commits took "
                               f"{shared['staged_round']} on the stream")
        if load["fsyncs"] != load["rounds"] or \
                load["shared_covered"] != load["commits"]:
            raise RuntimeError(f"shared stream: not one fsync a round "
                               f"covering its documents: {load}")
        fps = check_wal_docs(eng, writers)
        shared["flight_audit"] = flight_audits([eng.flight],
                                               "walshared shared")
        # ---- kill at post-fsync-pre-publish, recover --------------------
        doomed_ops = [Add(9 * 2**32 + i, ((9 * 2**32 + i - 1) if i > 1
                                          else 0,), f"x.{i}")
                      for i in range(1, 13)]
        os.environ["GRAFT_CRASH_POINT"] = W_CRASH_SITE
        box = {}

        def doomed():
            try:
                box["ack"] = eng.submit(
                    "dx", json_codec.dumps(Batch(tuple(doomed_ops))))
            except BaseException as e:   # noqa: BLE001 — the kill
                box["err"] = e

        try:
            threading.Thread(target=doomed, daemon=True).start()
            eng.scheduler.join(CALL_S)
            if eng.scheduler.is_alive():
                raise RuntimeError(f"{W_CRASH_SITE} never fired")
        finally:
            os.environ.pop("GRAFT_CRASH_POINT", None)
        if "ack" in box:
            raise RuntimeError("the killed write was acked")
        srv.shutdown()
        srv.server_close()               # the engine is not the server's
        th.join(60)
        if eng.maintenance is not None:  # a kill takes every thread
            eng.maintenance.stop(timeout=60)
        t0 = time.perf_counter()
        eng2 = ServingEngine(durable_dir=str(root / "shared"),
                             wal_sync="batch", wal_shared=True)
        shared["recovery_ready_s"] = time.perf_counter() - t0
        if eng2.device != dev:
            raise RuntimeError(f"recovered on {eng2.device}")
        try:
            recovered = [d.doc_id for d in eng2.docs() if d.recovered]
            if len(recovered) != W_DOCS + 1:
                raise RuntimeError(f"recovered {len(recovered)} documents")
            check_wal_docs(eng2, writers, fps)
            dx = list(eng2.get("dx", create=False).read_view().values)
            if dx != [o.value for o in doomed_ops]:
                raise RuntimeError("the fsynced killed write did not "
                                   "recover")
            shared["recovered_epoch"] = eng2.get("d0").epoch
        finally:
            eng2.close()
        shared["phase_s"] = time.perf_counter() - t_phase
        del eng, eng2, srv
        # ---- the same load with a WAL a document -----------------------
        t0 = time.perf_counter()
        srv, th, perdoc, writers = wal_load(root / "perdoc", False, wire,
                                            None, record)
        check_wal_docs(srv.store, writers)
        perdoc["flight_audit"] = flight_audits([srv.store.flight],
                                               "walshared per-doc")
        srv.shutdown()
        srv.server_close()
        th.join(60)
        srv.store.close()
        perdoc["phase_s"] = time.perf_counter() - t0
        launches = dict(kernels.launches)
        # document 0's giant single (vouched leg), the staged rounds'
        # batched merges (join leg)
        for k in ("plane_rows2", "prefix_sums", "monotone_gather",
                  *BATCHED_JOIN):
            if launches.get(k, 0) < 1:
                raise RuntimeError(f"the walshared phase never launched {k}")
        out.update(shared=shared, perdoc=perdoc, launches=launches,
                   phase_s=time.perf_counter() - t_phase)
        record["walshared"] = out

        def row(m):
            return {"fsyncs_per_round": round(m["load"]["fsyncs_per_round"],
                                              3),
                    "commits_per_fsync": round(
                        m["load"]["commits_per_fsync"], 3),
                    "fsyncs": m["load"]["fsyncs"],
                    "rounds": m["load"]["rounds"],
                    "ack_p50_ms": round(m["ack_p50_ms"], 1),
                    "ack_p99_ms": round(m["ack_p99_ms"], 1),
                    "writer_wall_s": round(m["writer_wall_s"], 2),
                    "giant_commit_ms": round(m["giant_commit_ms"], 1),
                    "flight_audit": m["flight_audit"]}
        log("walshared: " + json.dumps({
            "card": card, "shared": row(shared), "per_doc": row(perdoc),
            "staged_round": {k: shared["staged_round"][k]
                             for k in ("fsyncs", "shared_covered")},
            "recovery_ready_s": round(shared["recovery_ready_s"], 2),
            "phase_s": round(out["phase_s"], 1), "launches": launches}))
        log(f"walshared: killed at {W_CRASH_SITE}, {W_DOCS + 1} documents "
            f"recovered on the card in {shared['recovery_ready_s']:.2f} s; "
            f"every acked write reads back, every state_fingerprint kept, "
            f"d0 holds config 5's 1M values, the fsynced killed write "
            f"recovered")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def shmcache_phase(dev, record, card):
    """The host-shared body cache on the card: this process and a child
    ``python -m crdt_graph_tpu_torch.service`` serve with
    ``GRAFT_SHMCACHE=1`` in one ``GRAFT_SHMCACHE_NS``, and both take
    config 5 (1M ops) by one ``POST``, each merging on the card.  ``GET
    /docs/d0`` and ``/clock`` answer byte-identical bodies from both; the
    two count one miss and at least one hit for the generation (one
    encode on the host); after both close no ``graftshm-<ns>`` segment
    is left.  Returns this process's kernel launches."""
    import os
    import signal
    import uuid
    from crdt_graph_tpu_torch import kernels
    from crdt_graph_tpu_torch.bench import workloads
    from crdt_graph_tpu_torch.codec import packed as packed_mod
    from crdt_graph_tpu_torch.obs import prom
    from crdt_graph_tpu_torch.serve import ServingEngine
    from crdt_graph_tpu_torch.service import make_server

    ns = f"smoke{uuid.uuid4().hex[:8]}"
    t_phase = time.perf_counter()
    saved = os.environ.get("GRAFT_SHMCACHE_NS")
    os.environ["GRAFT_SHMCACHE_NS"] = ns
    env = dict(os.environ, GRAFT_SHMCACHE="1", PYTHONUNBUFFERED="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    child = subprocess.Popen(
        [sys.executable, "-m", "crdt_graph_tpu_torch.service", "0"],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE, text=True)
    srv = th = None
    out = {"card": card, "namespace": ns}

    def segments():
        try:
            return sorted(f for f in os.listdir("/dev/shm")
                          if f.startswith(f"graftshm-{ns}")
                          and not f.endswith(".manifest"))
        except OSError:
            return []

    try:
        eng = ServingEngine(shmcache=True)
        if eng.shmcache is None or eng.shmcache.namespace != ns:
            raise RuntimeError("the shared tier did not arm")
        srv = make_server(port=0, store=eng)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        line = child.stdout.readline()
        if "service on 127.0.0.1:" not in line:
            raise RuntimeError(f"the child server did not start: {line!r}")
        ports = {"this": srv.server_port,
                 "child": int(line.rsplit(":", 1)[1])}
        wire = packed_mod.packed_since_bytes(packed_chain(
            workloads.chain_workload(N_REPLICAS, N_OPS), N_OPS), 0)
        kernels.reset_launches()

        def post(who):
            c = Client(ports[who], timeout=600.0)
            for _ in range(N_REPLICAS):
                c.json("POST", "/docs/d0/replicas")
            t0 = time.perf_counter()
            a = c.json("POST", "/docs/d0/ops", body=wire)
            c.close()
            if a["applied_count"] != N_OPS:
                raise RuntimeError(f"{who}: bootstrap ack {a}")
            return (time.perf_counter() - t0) * 1e3

        posts = [Worker(f"post-{w}", lambda w=w: post(w)) for w in ports]
        run_threads(posts, 600.0)
        launches = dict(kernels.launches)
        out["commit_ms"] = {w: t.result for w, t in zip(ports, posts)}
        del wire
        bodies, etags, stats = {}, {}, {}
        for who in ("this", "child"):     # this one encodes, then the child
            c = Client(ports[who], timeout=600.0)
            t0 = time.perf_counter()
            st, vals, r = c.call("GET", "/docs/d0")
            out[f"first_read_ms_{who}"] = (time.perf_counter() - t0) * 1e3
            st2, clock, _ = c.call("GET", "/docs/d0/clock")
            if st != 200 or st2 != 200:
                raise RuntimeError(f"{who}: reads -> {st}, {st2}")
            bodies[who] = (vals, clock)
            etags[who] = r.getheader("ETag")
            fams = prom.parse_text(c.call("GET", "/metrics/prom")[1]
                                   .decode())
            stats[who] = {k: prom_total(fams, f"crdt_shmcache_{k}_total")
                          for k in ("hits", "misses", "attach_failed",
                                    "shared_bytes")}
            c.close()
        if bodies["this"] != bodies["child"] or \
                etags["this"] != etags["child"]:
            raise RuntimeError("the two servers answer different bodies")
        if len(json.loads(bodies["this"][0])["values"]) != N_OPS:
            raise RuntimeError("d0 does not serve 1M values")
        misses = stats["this"]["misses"] + stats["child"]["misses"]
        hits = stats["this"]["hits"] + stats["child"]["hits"]
        if misses != 1 or hits < 1 or stats["this"]["attach_failed"] \
                or stats["child"]["attach_failed"]:
            raise RuntimeError(f"not one encode on the host: {stats}")
        out["segments_live"] = segments()
        if len(out["segments_live"]) != 1:
            raise RuntimeError(f"segments {out['segments_live']}")
        out.update(stats=stats, values_bytes=len(bodies["this"][0]),
                   launches=launches)
        for k in ("plane_rows2", "prefix_sums", "monotone_gather"):
            if launches.get(k, 0) < 1:
                raise RuntimeError(f"the shmcache phase never launched {k}")
    finally:
        if child.poll() is None:
            child.send_signal(signal.SIGTERM)
        try:
            child_rc = child.wait(120)
        except subprocess.TimeoutExpired:
            child.kill()
            child_rc = child.wait(60)
        if srv is not None:
            srv.shutdown()
            srv.server_close()
            th.join(60)
            srv.store.close()
        if saved is None:
            os.environ.pop("GRAFT_SHMCACHE_NS", None)
        else:
            os.environ["GRAFT_SHMCACHE_NS"] = saved
    left = segments()
    try:
        os.unlink(f"/dev/shm/graftshm-{ns}.manifest")
    except OSError:
        pass
    if child_rc != 0:
        raise RuntimeError(f"the child server exited {child_rc}")
    if left:
        raise RuntimeError(f"segments left after both closed: {left}")
    out["phase_s"] = time.perf_counter() - t_phase
    record["shmcache"] = out
    log("shmcache: " + json.dumps({
        "card": card, "stats": out["stats"],
        "values_bytes": out["values_bytes"],
        "commit_ms": {k: round(v, 1) for k, v in out["commit_ms"].items()},
        "first_read_ms": {w: round(out[f"first_read_ms_{w}"], 1)
                          for w in ("this", "child")},
        "phase_s": round(out["phase_s"], 1),
        "launches": out["launches"]}))
    log("shmcache: /docs/d0 and /clock byte-identical from both servers, "
        "one encode on the host, no segment left after both closed")
    return out["launches"]


# the headline phase's depth: each entry point at the reference's widths
# (12-leaf deltas, 1M-op documents, the 140,000-op serve giant, 1,000
# watchers, 64-document shapes) with fewer sessions, writes and rounds
HL_SERVE = dict(n_sessions=32, writes_per_session=3)      # 200 x 24
HL_WAL = dict(writes_per_session=3, rounds=1)             # 12, 3 rounds
HL_PIPELINE = dict(writes_per_session=1, rounds=1)        # 6, 3 rounds
# coldpath's and storfloor's 64 documents get 2 sessions each writing
# once (the reference: 1 session a document writing 4 and 8 times), so
# their staged first rounds coalesce at once instead of waiting out the
# load generator's 30 s staging deadline for a second write
HL_COLDPATH = dict(restore_rounds=1, fleet_sessions=128, fleet_writes=1,
                   fleet_rounds=1)                        # 2, 64 x 4, 2
HL_STORFLOOR = dict(n_sessions=128, writes_per_session=1,
                    rounds=1)                             # 64 x 8, 3
HL_MERGETIER = dict(rounds=1)                             # 2 rounds
# bench_mergetier_headline's module shape: 2 documents a front-end with
# 2 sessions each (the reference: 4 with 1, whose staged first round
# waits out the load generator's 30 s deadline on every leg), 1 write
HL_MERGETIER_SHAPE = dict(N_DOCS=2, SESSIONS_PER_DOC=2,
                          WRITES_PER_SESSION=1)
HL_FLEET = dict(n_sessions=12, writes_per_session=3)      # 60 x 10
HL_VISIBILITY = dict(n_sessions=12, writes_per_session=3)  # 36 x 8
HL_FANOUT = dict(rounds=1)                                # 3 rounds
HL_FANOUT_WALL_S = 2.0                                    # 4 s a leg
HL_OPSAXIS = dict(repeats=1)                              # 3 repeats
HL_SLO = dict(reps=12)                                    # 60 a size
HL_SOAK = 6                                               # 60 sessions
HL_READPATH = dict(rounds=1)                              # 3 rounds
HL_READPATH_WRITES = 3                                    # 10 a session
# bench_broadcast_headline's own knobs (its BB_* environment): one
# repeat of one round at the reference's populations
HL_BROADCAST_ENV = {"BB_REPEATS": "1", "BB_ROUNDS": "1",  # 2 and 3
                    "BB_BIG_WATCHERS": "3000"}            # 10,000


def headline_phase(dev, record, twins, card):
    """The port's headline entry points (``crdt_graph_tpu_torch.scripts``)
    on the card, each through its own ``run(...)`` with no ``device=``
    (the card is the default), at the reference's widths and a cut depth
    (the ``HL_*`` constants; every cut is in the line's ``reduced``).

    Every kernel call of each entry point is recorded and held to its
    twin afterwards, as in the bench phase.  The correctness gates fail
    the phase: zero oracle violations and no errors; fingerprints equal
    (the oplog and cold-path originals against their restores, the
    ops-axis sharded merge against the single merge); no merge-tier
    fallback; readpath's and broadcast's two legs byte-identical; every
    acked write read back (the load generator's oracle, the SLO
    document's values, the served log of the end-to-end ``POST``).  The
    speed gates the references keep (ratios set on the CPU) are reported
    as data with their verdicts: an entry point whose speed gate alone
    fails raises ``SpeedGateFailed`` after writing its output and after
    its own correctness checks passed, and the phase reads the output
    back and holds its correctness fields too.  Every output that
    carries ``flight_audit`` is held to zero sampled audits over budget.
    Returns the kernel launches of the drive."""
    import contextlib
    import importlib
    import io
    import os
    from crdt_graph_tpu_torch import kernels
    from crdt_graph_tpu_torch.scripts._headline import SpeedGateFailed

    names = ("serve_smoke", "bench_serve_headline", "bench_wal_headline",
             "bench_pipeline_headline", "bench_oplog_headline",
             "bench_coldpath_headline", "bench_storfloor",
             "bench_mergetier_headline", "bench_fleet_headline",
             "bench_visibility_headline", "bench_fanout_headline",
             "bench_opsaxis_headline", "bench_service_e2e",
             "bench_egress", "bench_slo", "soak", "bench_readpath",
             "bench_broadcast_headline")
    saved = {k: os.environ.get(k) for k in HL_BROADCAST_ENV}
    os.environ.update(HL_BROADCAST_ENV)
    try:
        mods = {n: importlib.import_module(f"crdt_graph_tpu_torch.scripts.{n}")
                for n in names}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    t_phase = time.perf_counter()
    out = {"card": card, "twin_calls": {}, "seconds": {}, "entry": {}}
    errs_all = {}

    def checked(name, fn, out_file=None):
        """Run ``fn`` with every kernel call recorded and held to its
        twin.  An entry point that wrote ``out_file`` and then raised
        ``SpeedGateFailed`` (its speed gate alone missed; every other
        check of the run passed) returns that output with
        ``gate_raised`` set; any other raise fails the phase.  An output
        that carries ``flight_audit`` must show no sampled audit over
        budget."""
        got = {}

        def body():
            try:
                got["r"] = fn()
            except SpeedGateFailed as e:
                if out_file is None:
                    raise
                got["gate"] = e

        t0 = time.perf_counter()
        if out_file is not None:
            Path(out_file).unlink(missing_ok=True)
        with contextlib.redirect_stdout(io.StringIO()):
            caught = capture_inputs(body, wrapper_modules())
        out["seconds"][name] = time.perf_counter() - t0
        if "gate" in got:
            if not Path(out_file).exists():
                raise got["gate"]
            got["r"] = dict(json.loads(Path(out_file).read_text()),
                            gate_raised=repr(got["gate"])[:300])
            need(not got["r"]["gate"]["pass"],
                 f"{name}: SpeedGateFailed with its gate passing")
        errs = twin_errors(caught, twins)
        for k, e in errs.items():
            errs_all[k] = max(errs_all.get(k, 0.0), e)
        for k, v in caught.items():
            out["twin_calls"][k] = out["twin_calls"].get(k, 0) + len(v)
        del caught
        if any(e != 0 for e in errs.values()):
            raise RuntimeError(f"{name}: kernel calls differ from their "
                               f"twins: {errs}")
        fa = got["r"].get("flight_audit") if isinstance(got["r"], dict) \
            else None
        need(not (fa or {}).get("failures"),
             f"{name}: sampled audits over budget {fa}")
        return got["r"]

    def outfile(name):
        return str(ROOT / "build" / "headline" / f"BENCH_{name.upper()}.json")

    def need(cond, what):
        if not cond:
            raise RuntimeError(f"headline: {what}")

    entry = out["entry"]
    kernels.reset_launches()

    # 1. serve_smoke: every leg at its own (reference) size
    m = mods["serve_smoke"]
    s1 = checked("serve_smoke", lambda: m.run())
    s2 = checked("serve_smoke_fleet", lambda: m.run_fleet())
    s3 = checked("serve_smoke_fleet_procs", lambda: m.run_fleet_procs())
    s4 = checked("serve_smoke_mergetier", lambda: m.run_mergetier())
    need(s2["writes"] == 6 and s2["cross_server_ryw"] == 6
         and s2["fleet0"]["visible"] == 15, f"serve_smoke fleet {s2}")
    need(s3["misses"] == 4 and s3["hits"] == 8, f"shm ledger {s3}")
    need(s4["fallbacks"] == {} and s4["batch_width_max"] == 3,
         f"serve_smoke mergetier {s4}")
    entry["serve_smoke"] = {
        "visible": {d: v["visible"] for d, v in s1.items()
                    if d.startswith("smoke")},
        "watch": s1["watch"], "fleet": {k: s2[k] for k in (
            "writes", "forwarded", "cross_server_ryw")},
        "shm": {k: s3[k] for k in ("misses", "hits", "shared_bytes")},
        "mergetier": {k: s4[k] for k in (
            "remote_docs", "batch_width_max", "launches", "fallbacks")},
        "flight_audit": s1["flight_audit"]}

    def loadgen_ok(name, res, rep_key="report"):
        rep = res.get(rep_key) or {}
        need(res.get("violations_total", 0) == 0 and not rep.get("errors"),
             f"{name}: violations {res.get('violations_total')} errors "
             f"{rep.get('errors')}")
        need(rep.get("ops_merged", rep.get("leaves_acked"))
             == rep.get("leaves_acked"),
             f"{name}: acked leaves not all merged")

    # 2. the serving headline: the 140,000-op giant, 12-leaf deltas
    m = mods["bench_serve_headline"]
    r = checked("serve", lambda: m.run(**HL_SERVE))
    loadgen_ok("serve", r)
    entry["serve"] = {k: r[k] for k in (
        "sessions", "total_leaves", "ops_merged", "sustained_ops_per_sec",
        "read_p50_ms", "read_p99_ms", "violations_total")}
    entry["serve"].update(
        ack_p50_ms=r["report"]["ack_p50_ms"],
        ack_p99_ms=r["report"]["ack_p99_ms"],
        giant_commit_s=r["report"].get("giant_commit_s"),
        flight_audit=r["flight_audit"])

    # 3-4. durability tax, pipelined commit (legs raise on violations)
    r = checked("wal", lambda: mods["bench_wal_headline"].run(**HL_WAL))
    entry["wal"] = {
        "batch_vs_off_regression": r["batch_vs_off_regression"],
        "commit_vs_off_regression": r["commit_vs_off_regression"],
        "gate_batch_vs_off_le_0.25": r["batch_vs_off_regression"] <= 0.25,
        "ack_p50_ms": {mo: r["best"][mo]["ack_p50_ms"] for mo in r["best"]},
        "ack_p99_ms": {mo: r["best"][mo]["ack_p99_ms"] for mo in r["best"]},
        "acked_writes_per_s": {mo: r["best"][mo]["acked_writes_per_s"]
                               for mo in r["best"]},
        "fsyncs": {mo: r["best"][mo]["wal"]["fsyncs"] for mo in r["best"]
                   if r["best"][mo]["wal"]},
        "flight_audit": r["flight_audit"]}
    r = checked("pipeline", lambda: mods["bench_pipeline_headline"].run(
        **HL_PIPELINE))
    sp = r["pipelined_vs_serialized_speedup"]
    entry["pipeline"] = {
        "pipelined_vs_serialized_speedup": sp,
        "gate_speedup_ge_0.8": sp >= 0.8,
        "ack_p99_ms": {"pipelined": r["ack_p99_pipelined_ms"],
                       "serialized": r["ack_p99_serialized_ms"]},
        "acked_writes_per_s": {lg: r["best"][lg]["acked_writes_per_s"]
                               for lg in r["best"]},
        "flight_audit": r["flight_audit"]}

    # 5-6. the 1M-op document: cascade restore, cold paths
    r = checked("oplog", lambda: mods["bench_oplog_headline"].run())
    need(r["fingerprints_equal"], "oplog fingerprints differ")
    rs = r["restore"]
    entry["oplog"] = {
        "n_ops": r["n_ops"], "ingest_s": r["ingest_s"],
        "resident_ratio": r["resident"]["ratio"], "restore": rs,
        "gate_serving_ready_ge_5x":
            (rs["speedup_serving_ready"] or 0) >= 5.0,
        "windows": r["windows"], "fingerprints_equal": True}
    r = checked("coldpath", lambda: mods["bench_coldpath_headline"].run(
        **HL_COLDPATH))
    need(r["fingerprints_equal"], "coldpath fingerprints differ")
    fl = r["fleet"]
    need(all(g["violations"] == 0 for v in fl["all_rounds"].values()
             for g in v), "coldpath fleet violations")
    entry["coldpath"] = {
        "restore_speedup_to_first_read":
            r["restore"]["speedup_to_first_read"],
        "gate_restore_ge_5x": r["restore"]["speedup_to_first_read"] >= 5.0,
        "restore_total_s": {k: v["total_s"]
                            for k, v in r["restore"]["best"].items()},
        "catchup_first_touch_speedup":
            r["catchup"]["first_touch_speedup"],
        "fsyncs_per_round": {k: v["fsyncs_per_round"]
                             for k, v in fl["best"].items()},
        "fsyncs_per_round_reduction": fl["fsyncs_per_round_reduction"],
        "gate_fsync_reduction_ge_8x":
            fl["fsyncs_per_round_reduction"] >= 8.0
            and fl["shared_vs_perdoc_throughput"] >= 1.0,
        "shared_vs_perdoc_throughput": fl["shared_vs_perdoc_throughput"],
        "fingerprints_equal": True,
        "flight_audit": r["flight_audit"]}

    # 7. storage floor (its shm leg's ledger asserts inside)
    r = checked("storfloor", lambda: mods["bench_storfloor"].run(
        **HL_STORFLOOR))
    ab = r["sync_backend_ab"]
    entry["storfloor"] = {
        "fsync_stall_share_cut": ab["fsync_stall_share_cut"],
        "gate_share_cut_ge_2x": (ab["fsync_stall_share_cut"] or 0) >= 2.0,
        "median_stall_share": ab["median_stall_share"],
        "backend_resolved": {b: g["backend_resolved"]
                             for b, g in ab["best"].items()},
        "shm": {k: r["shm_fleet"][k] for k in ("misses", "hits")},
        "sendfile_windows": r["sendfile"]["windows_compared"],
        "flight_audit": r["flight_audit"]}

    # 8. the merge tier (no fallback on either tiered leg)
    mt = mods["bench_mergetier_headline"]
    saved_shape = {k: getattr(mt, k) for k in HL_MERGETIER_SHAPE}
    for k, v in HL_MERGETIER_SHAPE.items():
        setattr(mt, k, v)
    try:
        r = checked("mergetier", lambda: mt.run(**HL_MERGETIER),
                    outfile("mergetier"))
    finally:
        for k, v in saved_shape.items():
            setattr(mt, k, v)
    need(r["violations_total"] == 0 and r["errors_total"] == 0,
         f"mergetier violations/errors {r['violations_total']}/"
         f"{r['errors_total']}")
    for lg in ("coalesced", "perreplica"):
        need(not r["legs"][lg]["best"].get("fallbacks"),
             f"mergetier {lg} fallbacks {r['legs'][lg]['best']}")
    entry["mergetier"] = {
        "mean_width_ratio": r["mean_width_ratio"],
        "gate": r["gate"]["pass"],
        "mean_width": {lg: r["legs"][lg]["best"].get("mean_width")
                       for lg in r["legs"]},
        "writes_per_sec": {lg: r["legs"][lg]["best"]["writes_per_sec"]
                           for lg in r["legs"]},
        "flight_audit": r["flight_audit"]}

    # 9-10. the fleet, and its visibility ledger with the canary
    r = checked("fleet", lambda: mods["bench_fleet_headline"].run(
        **HL_FLEET))
    loadgen_ok("fleet", r)
    need(r["converged_docs"] == r["report"]["docs"], "fleet not converged")
    entry["fleet"] = {k: r[k] for k in (
        "servers", "sessions", "total_leaves", "sustained_ops_per_sec",
        "antientropy_lag_p50_s", "antientropy_lag_p99_s",
        "read_replica_p99_ms", "read_primary_p99_ms", "kill",
        "converged_docs", "violations_total")}
    entry["fleet"]["flight_audit"] = r["flight_audit"]
    r = checked("visibility", lambda: mods["bench_visibility_headline"].run(
        **HL_VISIBILITY))
    loadgen_ok("visibility", r)
    need(r["gate"]["zero_violations"], "visibility violations")
    entry["visibility"] = {
        "visibility_lag_s": r["visibility_lag_s"], "canary": r["canary"],
        "gate": r["gate"], "flight_audit": r["flight_audit"]}

    # 11. watch vs poll, and the 1,000-watcher fan-out
    fo = mods["bench_fanout_headline"]
    saved_wall, fo.AB_WALL_S = fo.AB_WALL_S, HL_FANOUT_WALL_S
    try:
        r = checked("fanout", lambda: fo.run(**HL_FANOUT), outfile("fanout"))
    finally:
        fo.AB_WALL_S = saved_wall
    need(r["violations_total"] == 0 and r["errors_total"] == 0
         and r["fanout"]["one_encode"], "fanout violations or encodes")
    entry["fanout"] = {
        "watchers": r["fanout"]["watchers"],
        "notify_ms": {k: r["fanout"]["notify_ms"].get(k)
                      for k in ("p50", "p99", "max")},
        "reads_delivered_per_sec_ratio": r["reads_delivered_per_sec_ratio"],
        "gate": r["gate"]["pass"]}

    # 12. the ops-axis A/B (kernel 5), bit-identical before timing
    r = checked("opsaxis", lambda: mods["bench_opsaxis_headline"].run(
        **HL_OPSAXIS))
    need(r["bit_identical"] and r["opsaxis_audit"]["ok"],
         f"opsaxis {r['opsaxis_audit']}")
    entry["opsaxis"] = {k: r[k] for k in (
        "n_ops", "devices", "p50_ms", "sharded_vs_single_speedup",
        "tripwire", "fingerprint")}
    entry["opsaxis"]["audit"] = {k: r["opsaxis_audit"][k] for k in (
        "shard_width", "shard_budget", "collective_bytes",
        "collective_count")}

    # 13. the service end to end, egress, the SLO, the soak
    r = checked("service_e2e", lambda: mods["bench_service_e2e"].run())
    need(r["wire_identical"], "service_e2e: served log != posted wire")
    entry["service_e2e"] = {g["leg"]: g["seconds"] for g in r["legs"]}
    r = checked("egress", lambda: mods["bench_egress"].run())
    entry["egress"] = {g["path"]: g["seconds"] for g in r["rows"]}
    r = checked("slo", lambda: mods["bench_slo"].run(**HL_SLO))
    entry["slo"] = {g["delta_ops"]: {"p50_ms": g["p50_ms"],
                                     "p99_ms": g["p99_ms"]}
                    for g in r["rows"]}
    r = checked("soak", lambda: mods["soak"].run(HL_SOAK))
    entry["soak"] = {"sessions": r["sessions"], "ops": r["ops"]}

    # 15. the two baselines as engine arguments
    rp = mods["bench_readpath"]
    saved_w = rp.WRITES_PER_SESSION
    rp.WRITES_PER_SESSION = HL_READPATH_WRITES
    try:
        r = checked("readpath", lambda: rp.run(**HL_READPATH),
                    outfile("readpath"))
    finally:
        rp.WRITES_PER_SESSION = saved_w
    wi = r["wire_identity"]
    need(all(wi[k] for k in ("doc_body_identical", "window_body_identical",
                             "etag_identical", "since_headers_identical")),
         f"readpath legs differ on the wire: {wi}")
    cp = r["conditional_poll"]
    need(cp["not_modified"] == cp["polls"] and cp["write_invalidates"],
         f"readpath conditional GET: {cp}")
    need(r["violations_total"] == 0, "readpath violations")
    entry["readpath"] = {
        "reads_per_sec": {lg: r["legs"][lg]["best"]["reads_per_sec"]
                          for lg in r["legs"]},
        "read_p99_ms": {lg: r["legs"][lg]["p99_best_ms"]
                        for lg in r["legs"]},
        "reads_per_sec_ratio": r["reads_per_sec_ratio"],
        "p99_ratio": r["p99_ratio"], "gate": r["gate"]["pass"],
        "wire_identity": wi}
    r = checked("broadcast", lambda: mods["bench_broadcast_headline"].run(),
                outfile("broadcast"))
    need(r["wire_identity"]["identical"],
         f"broadcast legs differ on the wire: {r['wire_identity']}")
    need(r["violations_total"] == 0 and r["errors_total"] == 0,
         "broadcast violations or errors")
    entry["broadcast"] = {
        "watchers": {"threaded": r["config"]["threaded_watchers"],
                     "reactor": r["config"]["ab_watchers"],
                     "capacity": r["config"]["big_watchers"]},
        "notify_p99_ms": {m_: r["ab"][m_]["best"]["notify_ms"]["p99"]
                          for m_ in r["ab"]},
        "capacity_notify_p99_ms": r["capacity"]["notify_ms"]["p99"],
        "threads_parked_delta": {
            m_: r["ab"][m_]["best"]["threads_parked_delta"]
            for m_ in r["ab"]},
        "watchers_per_host_ratio": r["watchers_per_host_ratio"],
        "notify_p99_ratio": r["notify_p99_ratio_reactor_over_threaded"],
        "gate": r["gate"]["pass"], "wire_identity": True}

    launches = dict(kernels.launches)
    for k in KERNELS:
        if launches.get(k, 0) < 1:
            raise RuntimeError(f"the headline phase never launched {k}")
    fold_errors(record, errs_all)
    out["launches"] = launches
    out["twin_err"] = errs_all
    out["phase_s"] = time.perf_counter() - t_phase
    out["reduced"] = {
        "serve": "sessions 200 -> 32, writes 24 -> 3",
        "wal": "writes 12 -> 3, rounds 3 -> 1",
        "pipeline": "writes 6 -> 1, rounds 3 -> 1",
        "coldpath": "restore rounds 2 -> 1, fleet 64 sessions x 4 "
                    "writes -> 128 x 1 (2 a document: the staged round "
                    "releases at once), fleet rounds 2 -> 1",
        "storfloor": "64 sessions x 8 writes -> 128 x 1 (2 a document), "
                     "rounds 3 -> 1",
        "mergetier": "documents a front-end 4 -> 2 with sessions a "
                     "document 1 -> 2 (4 sessions, as the reference), "
                     "writes 3 -> 1, rounds 2 -> 1",
        "fleet": "sessions 60 -> 12, writes 10 -> 3",
        "visibility": "sessions 36 -> 12, writes 8 -> 3",
        "fanout": "rounds 3 -> 1, each leg 4 -> 2 s",
        "opsaxis": "repeats 3 -> 1",
        "slo": "requests 60 -> 12 a size (20 -> 10 at 4,096)",
        "soak": f"sessions 60 -> {HL_SOAK}",
        "readpath": f"writes 10 -> {HL_READPATH_WRITES}, rounds 3 -> 1",
        "broadcast": "repeats 2 -> 1, rounds 3 -> 1, capacity leg "
                     "10,000 -> 3,000 watchers"}
    record["headline"] = out
    log("headline: " + json.dumps({
        "card": card, "phase_s": round(out["phase_s"], 1),
        "seconds": {k: round(v, 1) for k, v in out["seconds"].items()},
        "entry": entry, "reduced": out["reduced"],
        "launches": launches, "twin_calls": out["twin_calls"],
        "twin_max_abs_err": errs_all}))
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


SIDE_TIMEOUT_S = 1100          # the side child's limit, inside the script's


def twin_fns():
    """Each kernel's plain PyTorch version, by name (the batched forms'
    too)."""
    from crdt_graph_tpu_torch.ops import fused_resolve as fr, \
        mono_gather as mg, tour_scan as ts
    return {"plane_rows": fr.plain_rows, "plane_rows2": fr.plain_rows2,
            "prefix_sums": ts.plain_prefix,
            "monotone_gather": mg.plain_gather,
            "ring_exclusive": ts.plain_ring_exclusive,
            "plane_rows_batched": fr.plain_rows_batched,
            "plane_rows2_batched": fr.plain_rows2_batched,
            "prefix_sums_batched": ts.plain_prefix_batched,
            "monotone_gather_batched": mg.plain_gather_batched}


def side_start(route_on: bool):
    """Start ``chip_smoke.py --side-phases DIR`` (the ``walshared`` and
    ``headline`` phases) in its own process group, its output into
    ``DIR``; returns what :func:`side_join` and :func:`side_stop`
    take."""
    import os
    import shutil
    out = ROOT / "build" / "chip_smoke_side"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    args = [sys.executable, str(Path(__file__).resolve()), "--side-phases",
            str(out)] + (["--route-on"] if route_on else [])
    files = (open(out / "stdout.log", "w"), open(out / "stderr.log", "w"))
    proc = subprocess.Popen(args, stdout=files[0], stderr=files[1],
                            cwd=str(ROOT), start_new_session=True,
                            env=dict(os.environ, PYTHONUNBUFFERED="1"))
    return proc, out, files


def side_stop(side) -> None:
    """End the side child and every process it started (its group)."""
    import os
    import signal
    proc, _, files = side
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    for f in files:
        f.close()


def side_join(side) -> dict:
    """Wait for the side child (at most ``SIDE_TIMEOUT_S``), relay its
    lines to this process's output and its errors' tail to stderr, and
    return its result; raises when it failed or ran out of time."""
    proc, out, _ = side
    try:
        rc = proc.wait(SIDE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        rc = None
    side_stop(side)
    for line in (out / "stdout.log").read_text().splitlines():
        log(line)
    err = (out / "stderr.log").read_text()
    if rc != 0:
        print(err[-6000:], file=sys.stderr, flush=True)
        raise RuntimeError(f"the side phases' child "
                           f"{'ran out of time' if rc is None else f'exited {rc}'}")
    return json.loads((out / "result.json").read_text())


def side_phases_child(out_dir: str) -> int:
    """``--side-phases DIR``: the ``walshared`` and ``headline`` phases
    (each its own counted drive), beside the parent's phases; writes
    their record and launch counts to ``DIR/result.json``."""
    import torch
    sys.path.insert(0, str(ROOT))
    from crdt_graph_tpu_torch import native
    from crdt_graph_tpu_torch.bench import kerneltime
    from crdt_graph_tpu_torch.kernels import build
    import os
    import signal
    ppid = os.getppid()

    def orphaned():
        # this child leads its own process group: when the parent is
        # gone, end the group (the servers and drivers it started too)
        while os.getppid() == ppid:
            time.sleep(1.0)
        os.killpg(0, signal.SIGKILL)
    threading.Thread(target=orphaned, daemon=True).start()
    dev = torch.device(DEVICE)
    build.load()
    native.load()
    if not native.available():
        raise RuntimeError(f"native codec did not load: "
                           f"{native._build_error}")
    card = kerneltime.card_line()
    twins = twin_fns()
    record = {"kernels": {}, "phases": {}}
    launches = {}
    t0 = time.perf_counter()
    launches["walshared"] = dict(walshared_phase(dev, record, twins, card))
    record["phases"]["walshared_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["headline"] = dict(headline_phase(dev, record, twins, card))
    record["phases"]["headline_s"] = time.perf_counter() - t0
    (Path(out_dir) / "result.json").write_text(json.dumps(
        {"record": record, "launches": launches}))
    return 0


def main(argv=None) -> int:
    import argparse
    import os
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profiled-audit", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--side-phases", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--multidevice-child", nargs=3,
                    metavar=("PORT", "RANK", "DIR"), help=argparse.SUPPRESS)
    ap.add_argument(
        "--route-on", action="store_true",
        help="set GRAFT_OPSAXIS=1 for the run: on a host with two or more "
             "cards the engine's and the durable replicas' bulk merges of "
             "2^18 rows or more then take the ops-axis sharded merge, one "
             "shard a card (the route is off by default)")
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    if opts.profiled_audit:
        return profiled_audit_child()
    if opts.route_on:
        os.environ["GRAFT_OPSAXIS"] = "1"
    if opts.side_phases:
        return side_phases_child(opts.side_phases)
    if opts.multidevice_child:
        port, rank, out_dir = opts.multidevice_child
        return multidevice_child(int(port), int(rank), out_dir)
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from crdt_graph_tpu_torch import convert, kernels, native
    from crdt_graph_tpu_torch.bench import honest, kerneltime, workloads
    from crdt_graph_tpu_torch.bench.kerneltime import device_ms
    from crdt_graph_tpu_torch.codec import packed
    from crdt_graph_tpu_torch.kernels import build
    from crdt_graph_tpu_torch.ops import fused_resolve as fr
    from crdt_graph_tpu_torch.ops import merge, mono_gather as mg, \
        tour_scan as ts, view
    from crdt_graph_tpu_torch.parallel import opsaxis

    dev = torch.device(DEVICE)
    record = {"kernels": {}, "phases": {}}

    # ---- 1. the card --------------------------------------------------
    card = kerneltime.card_line()
    log(card)
    name = torch.cuda.get_device_name(0)
    record["card"] = card
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    record["route"] = {"route_on": opsaxis.route_on(),
                       "mesh_devices": opsaxis.mesh_devices(),
                       "bulk_merge_routed": opsaxis.enabled_for(1 << 20)}
    routed = record["route"]["bulk_merge_routed"]
    log(f"ops-axis route: {record['route']} (engine and durability bulk "
        f"merges {'sharded across the cards' if routed else 'on one card'})")

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

    # ---- the side phases (walshared, headline) start beside this one ---
    import atexit
    side = side_start(opts.route_on)
    atexit.register(side_stop, side)
    t_side = time.perf_counter()

    # ---- inputs of the main path (config 5, and with deletes) ---------
    t0 = time.perf_counter()
    adds = workloads.chain_workload(N_REPLICAS, N_OPS)
    dels = workloads.chain_with_deletes(N_OPS, DEL_EVERY, N_REPLICAS)
    record["phases"]["gen_s"] = time.perf_counter() - t0
    log(f"workloads: config 5 ({adds['kind'].shape[0]} ops) and config 5 "
        f"with every {DEL_EVERY}th node deleted ({dels['kind'].shape[0]} "
        f"ops) in {record['phases']['gen_s']:.2f} s")
    def vouched(arrs):
        """The main path's merge: a vouched batch in the exhaustive mode
        the engine dispatches for its own ingest."""
        return merge.materialize(arrs, hints="exhaustive", device=dev)

    caught = capture_inputs(lambda: (vouched(adds), vouched(dels)),
                            wrapper_modules(MERGE_KERNELS))
    torch.cuda.synchronize()

    # ---- 3. each kernel against its twin ------------------------------
    rng = np.random.default_rng(0)
    twins = twin_fns()
    calls = {"plane_rows": fr.plane_rows, "plane_rows2": fr.plane_rows2,
             "prefix_sums": ts.prefix_sums,
             "monotone_gather": mg.monotone_gather,
             "ring_exclusive": ts.ring_exclusive,
             "plane_rows_batched": fr.plane_rows_batched,
             "plane_rows2_batched": fr.plane_rows2_batched,
             "prefix_sums_batched": ts.prefix_sums_batched,
             "monotone_gather_batched": mg.monotone_gather_batched}

    def edge_cases(kname, args):
        """Synthetic inputs at the main-path shapes: negative hops,
        indices far outside any 1152-row window, out-of-range and
        negative indices, ragged last blocks; for kernel 4 a ``rid`` view
        at an odd offset and a step of 2, for kernel 3 no weight lanes and
        a lane one past a tile."""
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
            if kname == "plane_rows":
                out += kernel1_edges(plane, idx.to(dev))
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
            # the look-back scan's traps: no weight lanes (the sharded
            # cumsum's [0, W]), a lane one past a tile, values that wrap
            tile = ts.SCAN_TILE
            out.append((b[:-7], torch.zeros((0, w.shape[1]),
                                            dtype=torch.int32, device=dev)))
            out.append((torch.from_numpy(rng.integers(
                -2**31, 2**31 - 1, tile + 1, dtype=np.int64)
                .astype(np.int32)).to(dev),
                torch.from_numpy(rng.integers(
                    0, 2**31 - 1, (2, 3 * tile - 1), dtype=np.int64)
                    .astype(np.int32)).to(dev)))
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
        # rid as a view at an odd offset (the ops-axis chunks), and a
        # step of 2 inside one block (off the merge's monotone contract)
        out.append((vals, rid[3:]))
        step = rid.clone()
        step[5000:] += 1
        out.append((vals, step.clamp(max=vals.shape[1] - 1)))
        return out

    def kernel1_edges(plane, idx):
        """Kernel 1's widths and alignments: the main-path plane viewed
        one element in (8-byte aligned, so the one-column access); odd C
        = 3 and C = 17 at 200,003 rows; and every C = 1..21 on a 4,099-row
        plane that is 16-byte aligned, viewed one row in (8-byte aligned
        when C is odd) and one element in, at T = 0, 1 and 3,001 (ragged)
        with the extreme indices, and with the index a view one element
        in."""
        r = plane.shape[0]
        flat = torch.empty(r * plane.shape[1] + 1, dtype=torch.int64,
                           device=dev)
        flat[1:] = plane.reshape(-1)
        out = [(flat[1:].view(plane.shape), idx)]
        for c in (3, 17):
            big = torch.from_numpy(rng.integers(
                -2**63, 2**63 - 1, (200_003, c), dtype=np.int64)).to(dev)
            bidx = torch.from_numpy(rng.integers(
                -300_000, 300_000, 250_001).astype(np.int32)).to(dev)
            out += [(big, bidx), (big[1:], bidx[1:])]
        r = 4099
        ext = torch.tensor([-2**31, -r - 5, r + 99, 2**31 - 1, -1, -r],
                           dtype=torch.int32)
        for c in range(1, 22):
            base = torch.from_numpy(rng.integers(
                -2**63, 2**63 - 1, (r + 2) * c, dtype=np.int64)).to(dev)
            sidx = torch.from_numpy(rng.integers(
                0, r, 3002).astype(np.int32))
            sidx[1:7] = ext
            sidx = sidx.to(dev)
            for lo in (0, c, 1):
                p = base[lo:lo + r * c].view(r, c)
                out += [(p, sidx[1:1]), (p, sidx[1:2]), (p, sidx[:3001]),
                        (p, sidx[1:])]
        return out

    for kname in MERGE_KERNELS:
        cases = [args for args, _ in caught.get(kname, [])]
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
    for k in MERGE_KERNELS:
        if launches[k] < 1:
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

    # ---- 4b. the trace audit (its own counted drive) -------------------
    t0 = time.perf_counter()
    audit_launches = audit_phase(dev, record, adds, dels, card)
    record["phases"]["audit_s"] = time.perf_counter() - t0

    # ---- 5. the replica engine (its own counted drive) ----------------
    t0 = time.perf_counter()
    engine_launches = engine_phase(dev, record, twins)
    record["phases"]["engine_s"] = time.perf_counter() - t0
    fold_errors(record, record["engine"]["twin_err"])

    # ---- 6. durable replicas (their own counted drive) ----------------
    t0 = time.perf_counter()
    dur_launches = durability_phase(dev, record, twins)
    record["phases"]["durability_s"] = time.perf_counter() - t0
    fold_errors(record, record["durability"]["twin_err"])

    # ---- 7. the ops-axis sharded merge (its own counted drive) --------
    t0 = time.perf_counter()
    ops_launches, ring_args = opsaxis_phase(dev, record, adds, dels, twins)
    record["phases"]["opsaxis_s"] = time.perf_counter() - t0

    # ---- 8. the wire service (its own counted drive) ------------------
    t0 = time.perf_counter()
    serve_launches = serve_phase(dev, record, twins, card)
    record["phases"]["serve_s"] = time.perf_counter() - t0

    # ---- 9. the docs-axis batched merge, B = 1, 4, 16 (its own counted
    # drive at B = 16) ---------------------------------------------------
    t0 = time.perf_counter()
    mesh_launches, batched_args = mesh_phase(dev, record, twins, card)
    record["phases"]["mesh_s"] = time.perf_counter() - t0

    # ---- 9b. the multi-device layer (its own counted drive) -------------
    t0 = time.perf_counter()
    md_launches = multidevice_phase(dev, record, adds, dels, twins, card)
    record["phases"]["multidevice_s"] = time.perf_counter() - t0

    # ---- 9a. the batched kernels against their twins: the mesh phase's
    # calls (held there), then per-document traps at its shapes ----------
    for kname in BATCHED:
        if kname not in batched_args:
            raise RuntimeError(f"the batched merge never called {kname}")
        errs = []
        for args in batched_edge_cases(kname, batched_args[kname], rng, dev):
            got = _outputs(calls[kname](*args))
            want = _outputs(twins[kname](*_cpu(args)))
            torch.cuda.synchronize()
            errs.append(max_abs_err(got, want))
        fold_errors(record, {kname: max(errs)})
        record["kernels"][kname]["edge_cases"] = len(errs)
        log(f"kernel {kname}: {len(errs)} edge cases vs batched twin, "
            f"max_abs_err {max(errs)}")
        if max(errs) != 0:
            raise RuntimeError(f"{kname} disagrees with its batched twin")

    # ---- 10. the merge tier and the fleet (their own counted drive) ----
    t0 = time.perf_counter()
    fleet_launches = fleet_phase(dev, record, twins, card)
    record["phases"]["fleet_s"] = time.perf_counter() - t0

    # ---- 11. the benches (their own counted drive) ---------------------
    t0 = time.perf_counter()
    bench_launches = bench_phase(dev, record, twins, card)
    record["phases"]["bench_s"] = time.perf_counter() - t0

    # ---- 12. the host-shared body cache (its own counted drive) ---------
    t0 = time.perf_counter()
    shm_launches = shmcache_phase(dev, record, card)
    record["phases"]["shmcache_s"] = time.perf_counter() - t0
    record["phases"]["main_s"] = time.perf_counter() - t_side

    # ---- 13-14. the side child: the shared WAL stream (its launches
    # share the shmcache's column) and the headline entry points --------
    got = side_join(side)
    record["phases"]["side_wait_s"] = (time.perf_counter() - t_side
                                       - record["phases"]["main_s"])
    for key, val in got["record"].items():
        if key not in ("kernels", "phases"):
            record[key] = val
    record["phases"].update(got["record"]["phases"])
    fold_errors(record, {k: v["max_abs_err"]
                         for k, v in got["record"]["kernels"].items()})
    wal_shm_launches = dict(got["launches"]["walshared"])
    for k, n in shm_launches.items():
        wal_shm_launches[k] = wal_shm_launches.get(k, 0) + n
    headline_launches = got["launches"]["headline"]
    log("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in record["phases"].items()}))

    # ---- 15. timing -----------------------------------------------------
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

    # kernel 1 at two more widths, captured from 1M-op unvouched merges
    k1_widths = {key: a for key, a in kerneltime.kernel1_inputs(dev).items()
                 if key != "plane_rows"}
    rows = []
    for kname, (src, replaces) in {**KERNELS, **BATCHED}.items():
        args = ring_args if kname == "ring_exclusive" else \
            batched_args[kname] if kname in BATCHED else caught[kname][0][0]
        tk = kerneltime.time_kernel(kname, calls[kname], twins[kname], args)
        rec = record["kernels"][kname]
        rec["timing"] = tk
        # device time by the profiler (kerneltime raises where it records
        # none): CUDA events around back-to-back calls time the wrapper's
        # host work when it outlasts the kernel
        k_ms, p_ms, l_ms = (tk[f]["device_ms"] for f in
                            ("kernel", "plain", "library"))
        c_ms = tk["kernel"]["cold_ms"]
        b_ms, b_by = tk["bound_ms"], tk["bound_by"]
        rec.update({"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "bytes": tk["bytes"],
                    "timed_shapes": [list(a.shape) for a in args
                                     if hasattr(a, "shape")] or
                    [[len(args[0]), int(args[0][0].shape[0])]]})
        variants = {v: device_ms(f) for v, f in
                    kerneltime.library_variants(kname, args).items()}
        if variants:
            rec["library_variants_ms"] = variants
            log(f"library calls for {kname} (profiler device time, L2 "
                f"warm): " + json.dumps(
                    {v: round(t, 5) for v, t in variants.items()}))
        ratio = tk["library_ratio"]
        rec.update({f: tk[f] for f in ("launch_floor_ms", "floor_bound_ms",
                                        "floor_share")})
        log(f"launch floor (one-element add, L2-cold clock) "
            f"{tk['launch_floor_ms']:.5f} ms: {kname}'s bound with it "
            f"{tk['floor_bound_ms']:.3e} ms, share of cold time "
            f"{tk['floor_share']:.3f}")
        log(f"time {kname} {rec['timed_shapes']} (profiler device time, L2 "
            f"warm): kernel {k_ms:.4f} ms, twin {p_ms:.4f} ms, library "
            f"{'-' if l_ms is None else f'{l_ms:.4f}'} ms, kernel/library "
            f"{'-' if ratio is None else f'{ratio:.3f}'}; L2 cold: kernel "
            f"{c_ms:.4f} ms, bound {b_ms:.3e} ms ({tk['bytes']} B), bound "
            f"share {tk['bound_share']:.3f}; events kernel "
            f"{tk['kernel']['events_ms']:.4f} twin "
            f"{tk['plain']['events_ms']:.4f} ms; host per wrapper call "
            f"{tk['kernel']['host_us']:.2f} us (twin "
            f"{tk['plain']['host_us']:.2f} us)")
        widths = []
        for key, wargs in (k1_widths.items() if kname == "plane_rows"
                           else ()):
            err = max_abs_err(_outputs(calls[kname](*wargs)),
                              _outputs(twins[kname](*_cpu(wargs))))
            fold_errors(record, {kname: err})
            wt = kerneltime.time_kernel(kname, calls[kname], twins[kname],
                                        wargs)
            w = {"case": key, "shape": [list(a.shape) for a in wargs],
                 "max_abs_err": err, "bound_ms": wt["bound_ms"],
                 "bound_share": wt["bound_share"],
                 "library_ratio": wt["library_ratio"],
                 "cold_ms": wt["kernel"]["cold_ms"],
                 "events_ms": wt["kernel"]["events_ms"],
                 "host_us": wt["kernel"]["host_us"]}
            w.update({f"{f}_ms" if f != "kernel" else "ms":
                      wt[f]["device_ms"]
                      for f in ("kernel", "plain", "library")})
            widths.append(w)
            log(f"time {kname} {w['shape']} ({key}; profiler device time, "
                f"L2 warm): kernel {w['ms']:.4f} ms, twin "
                f"{w['plain_ms']:.4f} ms, library (index_select of rows) "
                f"{w['library_ms']:.4f} ms, kernel/library "
                f"{w['library_ratio']:.3f}; L2 cold: kernel "
                f"{w['cold_ms']:.4f} ms, bound {w['bound_ms']:.3e} ms, "
                f"bound share {w['bound_share']:.3f}; host per wrapper "
                f"call {w['host_us']:.2f} us; max_abs_err {err}")
            if err != 0:
                raise RuntimeError(f"{kname} disagrees with its twin at "
                                   f"{key}")
        if widths:
            rec["widths"] = widths
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": sum(d.get(kname, 0) for d in (
                         launches, audit_launches, engine_launches,
                         dur_launches, ops_launches, serve_launches,
                         mesh_launches, fleet_launches, bench_launches,
                         wal_shm_launches, headline_launches, md_launches)),
                     "launches_mesh": mesh_launches.get(kname, 0),
                     "launches_serve": serve_launches.get(kname, 0),
                     "launches_fleet": fleet_launches.get(kname, 0),
                     "launches_multidevice": md_launches.get(kname, 0),
                     "launches_wal_shm": wal_shm_launches.get(kname, 0),
                     "launches_headline": headline_launches.get(kname, 0),
                     "launches_audit": audit_launches.get(kname, 0),
                     "max_abs_err": rec["max_abs_err"], "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": l_ms,
                     "device_ms": k_ms, "cold_ms": c_ms,
                     "events_ms": tk["kernel"]["events_ms"],
                     "host_us": tk["kernel"]["host_us"],
                     "launch_floor_ms": tk["launch_floor_ms"],
                     "floor_bound_ms": tk["floor_bound_ms"],
                     "floor_share": tk["floor_share"],
                     **({"widths": widths} if widths else {})})
    log(f"profiler sessions that recorded no device time and were taken "
        f"again: {kerneltime.empty_sessions}")

    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / ("chip_smoke_route_on.json" if opts.route_on else
                "chip_smoke.json")).write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
