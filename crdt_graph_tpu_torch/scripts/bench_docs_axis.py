"""Config 5 settled on the DOCS axis: ``n_docs`` × ``ops_per_doc``-op
independent merges through ``mesh.batched_materialize`` on a docs mesh
of logical devices, against the same merges run one after another on
one device — the port's counterpart of ``scripts/bench_docs_axis.py``,
on the card unless ``device`` names another.

Each document is config-5-shaped (the 64-chain join) with a replica-id
space of its own (distinct documents, not one array aliased n times).
The mesh is ``docs = n_docs × ops = 1`` over ``mesh.logical_devices``:
n entries of the one card (or of the CPU), or the visible cards in turn.
Documents whose rows lie on one device merge as ONE batched merge over a
leading document axis (one chain of dispatches and host reads, each
kernel launched once for the batch), so on one card the 8 documents are
one merge; with a card a row each, each card merges its own.  The
output's ``path`` names that.

Every batched document must show every op visible (``num_visible ==
ops_per_doc`` when 64 divides it, as at the default 1M).
Writes ``build/headline/BENCH_DOCS_AXIS.json``.  Run: ``python -m
crdt_graph_tpu_torch.scripts.bench_docs_axis [n_docs] [ops_per_doc]
[--device cpu]``.
"""
import json
import os
import sys
import time

import numpy as np

from . import _headline
from ..bench import workloads
from ..codec.packed import KIND_ADD
from ..ops import merge
from ..parallel import mesh as mesh_mod

REPEATS = 3


def _doc_workload(doc: int, n_ops: int) -> dict:
    """An independent config-5-shaped document: the same 64-chain
    structure, a disjoint replica-id space per document."""
    arrs = dict(workloads.chain_workload(64, n_ops))
    shift = np.int64(doc * 64) << 32
    for k in ("ts", "anchor_ts"):
        arrs[k] = np.where(arrs[k] > 0, arrs[k] + shift, arrs[k])
    arrs["paths"] = np.where(arrs["paths"] > 0, arrs["paths"] + shift,
                             arrs["paths"])
    return arrs


def run(n_docs: int = 8, ops_per_doc: int = 1_000_000, device=None,
        out_path: str = None) -> dict:
    dev = _headline.resolve(device)
    docs = [_doc_workload(d, ops_per_doc) for d in range(n_docs)]
    stacked = {k: np.stack([d[k] for d in docs]) for k in docs[0]}
    devs = mesh_mod.logical_devices(n_docs, device)
    mesh = mesh_mod.make_mesh(n_docs=n_docs, n_ops=1, devices=devs)
    total = n_docs * ops_per_doc

    def batched():
        t = mesh_mod.batched_materialize(stacked, mesh,
                                         exhaustive_hints=True)
        return t, t.num_visible.cpu().numpy()

    # every op of a chain document is a visible add (ops_per_doc of
    # them when 64 divides it)
    want = [int(np.sum(d["kind"] == KIND_ADD)) for d in docs]
    t0 = time.perf_counter()
    _, visible = batched()
    first_s = time.perf_counter() - t0
    assert visible.tolist() == want, (visible, want)
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        batched()
        times.append(time.perf_counter() - t0)
    batched_s = sorted(times)[len(times) // 2]

    # the same documents, one whole merge each, on one device
    def seq_one(arrs):
        t = merge.materialize(arrs, hints="exhaustive", device=devs[0])
        return int(t.num_visible)

    seq_one(docs[0])
    t0 = time.perf_counter()
    seq_visible = [seq_one(d) for d in docs]
    seq_s = time.perf_counter() - t0
    assert seq_visible == visible.tolist(), (seq_visible, visible)

    block = _headline.device_block(dev)
    out = {
        "n_docs": n_docs, "ops_per_doc": ops_per_doc,
        "host_cores": os.cpu_count(),
        "mesh": "docs=%d x ops=1 (logical devices %s)" % (
            n_docs, ", ".join(str(d) for d in devs)),
        "path": "mesh.batched_materialize(exhaustive_hints=True): the "
                "documents of consecutive docs rows on one device as one "
                "batched merge over a leading document axis",
        "platform": _headline.platform_tag(block),
        "device": block,
        "num_visible": visible.tolist(),
        "batched_p50_s": batched_s,
        "batched_times_s": times,
        "batched_agg_ops_per_s": total / batched_s,
        # the first batched call (the kernels' build on a fresh checkout)
        "batched_compile_s": first_s,
        "seq_single_device_s": seq_s,
        "seq_agg_ops_per_s": total / seq_s,
        "batched_vs_seq": seq_s / batched_s,
    }
    _headline.write(out, out_path or _headline.out_path("docs_axis"))
    print(json.dumps({k: out[k] for k in (
        "n_docs", "ops_per_doc", "mesh", "path", "batched_p50_s",
        "seq_single_device_s", "batched_vs_seq")}), flush=True)
    return out


def main(argv=None) -> int:
    device, argv = _headline.split_device(
        list(sys.argv[1:] if argv is None else argv))
    n_docs = int(argv[0]) if len(argv) > 0 else 8
    per_doc = int(argv[1]) if len(argv) > 1 else 1_000_000
    run(n_docs, per_doc, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
