"""Benchmark runner: times the merge on the card for the eight configs.

Prints one JSON line per config:
``{"config": n, "name": ..., "n_ops": N, "p50_ms": ..., "ops_per_sec": ...}``

Timing is honest by construction (``bench.honest``): the op columns are
copied to the card first, then each repeat is one merge + fingerprint
(+ order check) on the card, a synchronize and an 8-byte readback of a
scalar that depends on the result; after the repeats a dispatch → sleep
→ readback audit checks that the readback really waits for the stream.

Usage: ``python -m crdt_graph_tpu_torch.bench [--device cpu] [configs]``
and ``python -m crdt_graph_tpu_torch.bench headline``.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..codec import packed as packed_mod
from ..convert import ops_from_numpy
from ..ops import merge
from . import honest, workloads

# Fingerprint composition version, in every row so rows of different
# compositions are never compared.  v2: the order-check mode folds
# (doc_index, status, gathered seq); the no-expected mode folds
# (doc_index, visible_order, status, ts).  The two modes do not compare
# with each other, and neither matches v1 (which always folded the
# no-expected composition).  A fingerprint mismatch across rows with
# different ``fingerprint_v``, or with equal v and different check
# modes, is a composition difference, not a divergence of the merge.
FINGERPRINT_V = 2


def _as_arrays(workload) -> Dict[str, np.ndarray]:
    if isinstance(workload, dict):
        return workload
    return packed_mod.pack(workload).arrays()


def _summary_fn(dev: torch.device, no_deletes: bool = False, hints=None):
    """The merge returning only small dependent outputs: a fingerprint
    over the order-defining fields and the node / visible counts and,
    when an expected sequence rides along, an order-exactness flag
    computed on ``dev`` — all four stacked in one int64[4] tensor, so a
    repeat ends on one copy.  ``no_deletes`` is the host-checked promise
    from :func:`time_merge`."""
    def fn(ops, *expected):
        t = merge._materialize(ops, hints, dev, no_deletes)
        if expected:
            # the full-width gathered sequence joins the fingerprint: the
            # order check compares only a prefix (num_visible < M), which
            # would leave visible_order's tail out of the checksum
            exp = expected[0]
            seq = t.ts[t.visible_order.long()]
            fp = honest.fingerprint((t.doc_index, t.status, seq))
            ok = torch.all(seq[:exp.shape[0]] == exp) & \
                (t.num_visible == exp.shape[0])
        else:
            fp = honest.fingerprint(
                (t.doc_index, t.visible_order, t.status, t.ts))
            ok = torch.ones((), dtype=torch.bool, device=dev)
        return torch.stack([fp, t.num_nodes.to(torch.int64),
                            t.num_visible.to(torch.int64),
                            ok.to(torch.int64)])
    return fn


def time_merge(ops: Dict[str, np.ndarray], repeats: int = 5,
               progress: bool = False, audit: bool = True,
               expected_ts: Optional[np.ndarray] = None,
               hints: Optional[str] = None, device=None) -> dict:
    """Honestly time the merge of ``ops`` on ``device`` (default the
    card; it raises without one).  With ``expected_ts`` every repeat
    also checks the whole visible sequence against it on the device
    (``order_exact`` in the result).  ``hints="exhaustive"`` times the
    engine's path for vouched batches (the generators build exact hints,
    and the order check still judges the result independently)."""
    def _log(msg: str) -> None:
        if progress:
            print(f"bench: {msg}", file=sys.stderr, flush=True)

    dev = merge.resolve_device(device)
    dev_ops = ops_from_numpy(ops, dev)
    args = (dev_ops,) if expected_ts is None else \
        (dev_ops, torch.from_numpy(np.asarray(expected_ts)).to(dev))
    _log("arrays on device")
    no_deletes = merge.host_no_deletes(np.asarray(ops["kind"]))
    fn = _summary_fn(dev, no_deletes=no_deletes, hints=hints)
    last = {}

    def timed(*a):
        last["out"] = fn(*a)
        return last["out"]
    stats = honest.time_with_readback(timed, *args, repeats=repeats,
                                      log=_log)
    _, num_nodes, num_visible, order_ok = honest.force(last["out"])
    n = int(np.sum(np.asarray(ops["kind"]) != packed_mod.KIND_PAD))
    p50_s = stats["p50_ms"] / 1e3
    floor_ms = honest.overhead_floor_ms(dev)
    out = {
        "n_ops": n,
        "fingerprint_v": FINGERPRINT_V,
        "p50_ms": stats["p50_ms"],
        "ops_per_sec": n / p50_s,
        "compile_ms": stats["warm_ms"],
        "num_nodes": int(num_nodes),
        "num_visible": int(num_visible),
        # a trivial launch + 8-byte copy: the fixed cost inside every
        # repeat; p50 stays the headline
        "dispatch_overhead_ms": floor_ms,
        "p50_minus_rtt_ms": max(stats["p50_ms"] - floor_ms, 0.0),
        "device": str(dev),
    }
    if expected_ts is not None:
        out["order_exact"] = bool(order_ok)
    if audit:
        out["audit"] = honest.audit_async_gap(
            fn, *args, expected_s=p50_s, log=_log)
    return out


_CLOSED_FORMS = {
    5: lambda: workloads.chain_expected_ts(64, 1_000_000),
    6: lambda: workloads.descending_expected_ts(4096, 1_000_000),
    7: lambda: workloads.comb_expected_ts(1_000_000),
    8: lambda: workloads.deep_expected_ts(64, 1_000_000),
}


def _mirror_expected(raw) -> np.ndarray:
    """Expected visible sequence for an op-list config via the host
    mirror (itself pinned against the oracle)."""
    from ..core.operation import Add
    from ..host_tree import HostTree

    m = HostTree(16)
    for op in raw:
        if isinstance(op, Add):
            m.apply_add(op.ts, tuple(op.path), op.value)
        else:
            m.apply_delete(tuple(op.path))
    return np.array([int(m.ts[s]) for s in m.iter_visible()],
                    dtype=np.int64)


def _divergence_detail(ops: Dict[str, np.ndarray], expected: np.ndarray,
                       device=None) -> str:
    """Untimed diff for a failed order check: merges once more outside
    the timing and names the first divergent visible index."""
    t = merge.materialize(ops, device=device)
    nv = int(t.num_visible)
    seq = t.ts[t.visible_order.long()][:nv].cpu().numpy()
    n_got, n_want = int(seq.shape[0]), int(expected.shape[0])
    m = min(n_got, n_want)
    diff = np.nonzero(seq[:m] != expected[:m])[0]
    if diff.size:
        i = int(diff[0])
        return (f"first divergence at visible index {i} "
                f"(got ts {int(seq[i])}, want {int(expected[i])}); "
                f"got {n_got} visible, want {n_want}")
    return (f"sequences agree on the first {m} entries; "
            f"got {n_got} visible, want {n_want}")


def run(config_ids: Optional[Iterable[int]] = None,
        repeats: int = 5, check: bool = True,
        hints: Optional[str] = None, device=None) -> list:
    """Time every config on ``device`` (default the card; it raises
    without one), the order check in every timed repeat: op-list
    configs against the host-mirror replay, array configs against their
    closed form."""
    dev = merge.resolve_device(device)
    results = []
    for cid in (config_ids or sorted(workloads.CONFIGS)):
        name, gen = workloads.CONFIGS[cid]
        raw = gen()
        ops = _as_arrays(raw)
        expected = None
        if check:
            expected = _CLOSED_FORMS[cid]() if isinstance(raw, dict) \
                else _mirror_expected(raw)
        stats = time_merge(ops, repeats=repeats, expected_ts=expected,
                           hints=hints, device=dev)
        # the hint mode in every row: exhaustive and auto rows differ
        # in the leg they time, never to be read as a kernel change
        row = {"config": cid, "name": name, "hints": hints or "auto",
               **stats}
        if check:
            exact = row.pop("order_exact")
            row["order_check"] = "exact" if exact else (
                "MISMATCH: " + _divergence_detail(ops, expected, dev))
        results.append(row)
        print(json.dumps(row), flush=True)
    return results


N_HEADLINE_REPLICAS = 64
N_HEADLINE_OPS = 1_000_000
TARGET_OPS_PER_S = 1e7          # the north star: 1M ops in 100 ms


def headline(repeats: int = 5, device=None) -> dict:
    """Config 5 (64 replicas' chains, 1M ops) in the vouched exhaustive
    mode, order-checked against the closed form in every repeat, as one
    line in the shape of the reference's ``bench.py``."""
    dev = merge.resolve_device(device)
    ops = workloads.chain_workload(N_HEADLINE_REPLICAS, N_HEADLINE_OPS)
    stats = time_merge(ops, repeats=repeats,
                       expected_ts=workloads.chain_expected_ts(
                           N_HEADLINE_REPLICAS, N_HEADLINE_OPS),
                       hints="exhaustive", device=dev)
    if stats["num_visible"] != stats["n_ops"]:
        raise RuntimeError("merge dropped ops")
    if not stats["audit"]["ok"]:
        raise RuntimeError(f"timing audit failed: {stats['audit']}")
    if not stats["order_exact"]:
        raise RuntimeError("visible order deviates from the closed form")
    ops_per_s = stats["ops_per_sec"]
    return {
        "metric": "crdt_merge_throughput_64rep_1Mops",
        "value": ops_per_s,
        "unit": "ops/s",
        "vs_baseline": ops_per_s / TARGET_OPS_PER_S,
        "device": device_name(dev),
        "p50_ms": stats["p50_ms"],
        "order_check": "exact",
        "kernel_mode": "exhaustive (the production mode for vouched "
                       "batches; order-checked against the closed form "
                       "in every timed repeat)",
        "audit": stats["audit"],
        "dispatch_overhead_ms": stats["dispatch_overhead_ms"],
    }


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else str(dev)


def main(argv) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m crdt_graph_tpu_torch.bench",
        description="Time the merge of the benchmark configs (or the "
                    "config-5 headline) honestly on the card.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs the plain PyTorch path)")
    ap.add_argument("--hints", default=None,
                    choices=("auto", "exhaustive", "join"))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("configs", nargs="*",
                    help="config numbers (default all), or 'headline'")
    opts = ap.parse_args(argv)
    dev = merge.resolve_device(opts.device)
    print(f"# device: {device_name(dev)}", file=sys.stderr)
    if opts.configs == ["headline"]:
        print(json.dumps(headline(opts.repeats, dev)), flush=True)
        return
    run([int(a) for a in opts.configs] or None, repeats=opts.repeats,
        hints=None if opts.hints == "auto" else opts.hints, device=dev)


if __name__ == "__main__":
    main(sys.argv[1:])
