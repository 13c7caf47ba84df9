"""The port's spans and counts in the merge tier
(``crdt_graph_tpu_torch.utils.profiling``), on the CPU.

One front-end's remote merge, as the serving scheduler's remote stage
makes it for one document: a replica holding a nested document (the
port's ``bench/workloads.nested_tree``, depth 8) prepares the candidate
set of a delta and ships it through ``MergeTierClient.merge_one`` to an
in-process ``MergeWorker``, whose epoch has width 1.  The worker runs
on the client's thread, so while a ``torch.profiler`` session records,
the call is one tree of span-log records under ``mergetier.merge_one``;
with none, only the always-on span registry moves.
"""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crdt_graph_tpu_torch import engine as tengine
from crdt_graph_tpu_torch.bench import workloads
from crdt_graph_tpu_torch.codec import packed as tpacked
from crdt_graph_tpu_torch.mergetier import wire
from crdt_graph_tpu_torch.mergetier.client import MergeTierClient
from crdt_graph_tpu_torch.mergetier.worker import MergeWorker, read_back
from crdt_graph_tpu_torch.ops.merge import FIELDS
from crdt_graph_tpu_torch.parallel import mesh
from crdt_graph_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)

BASE, DELTA = 3000, 1200
ROOT = "mergetier.merge_one"
# each span's parent in a remote merge's tree (the digest under each
# codec span that hashes)
PARENT = {
    "mergetier.encode_request": ROOT,
    "mergetier.decode_request": ROOT,
    "mergetier.batch_wait": ROOT,
    "mergetier.launch": ROOT,
    "mergetier.read_back": "mergetier.launch",
    "mergetier.encode_response": ROOT,
    "mergetier.decode_response": ROOT,
    "mergetier.verify": ROOT,
}
HASHING = ("mergetier.encode_request", "mergetier.decode_request",
           "mergetier.encode_response", "mergetier.decode_response")


@pytest.fixture(scope="module")
def front():
    """(tree holding the base, delta, in-process worker, client)."""
    ops = workloads.nested_tree(BASE + DELTA, n_replicas=8, depth=8, seed=5)
    t = tengine.TpuTree(9, device="cpu")
    t.apply_packed(tpacked.pack(ops[:BASE]))
    delta = tpacked.pack(ops[BASE:])
    worker = MergeWorker(device="cpu")
    yield t, delta, worker, MergeTierClient([worker])
    worker.close()


@pytest.fixture(autouse=True)
def _fresh_registry(monkeypatch):
    monkeypatch.delenv("GRAFT_DEBUG_VOUCH", raising=False)
    tprof.reset_spans()
    yield
    tprof.reset_spans()


def _merge(front, bodies=None):
    """One remote merge of the delta's candidate set; ``bodies`` (a
    list) collects the request and response bodies.  Returns (the
    candidate set, the client's answer)."""
    t, delta, worker, client = front
    p = t.prepare_packed(delta)
    if bodies is not None:
        send = client.workers[0].obj.handle_merge

        class Tap:
            name = worker.name

            def handle_merge(self, body):
                out = send(body)
                bodies.extend([body, out[1]])
                return out
        client.workers[0].obj = Tap()
    try:
        return p, client.merge_one("doc", p, delta.num_ops)
    finally:
        client.workers[0].obj = worker


def _tree(records):
    roots = [r for r in records if r["name"] == ROOT and r["parent"] is None]
    assert len(roots) == 1
    return [r for r in records if r["root"] == roots[0]["id"]]


def test_a_profiled_merge_logs_one_tree(front):
    bodies = []
    with profile(activities=[ProfilerActivity.CPU]):
        _, (_, shared, width, _) = _merge(front, bodies)
    log = tprof.span_log()
    assert log["dropped"] == 0
    recs = _tree(log["records"])
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        if r["name"] == ROOT:
            continue
        up = by_id[r["parent"]]
        if r["name"] in PARENT:
            assert up["name"] == PARENT[r["name"]], r["name"]
        if r["name"] == "mergetier.digest":
            assert up["name"] in HASHING
        assert up["start_ns"] <= r["start_ns"] <= r["end_ns"] <= up["end_ns"]
        assert r["thread"] == up["thread"]
    names = collections.Counter(r["name"] for r in recs)
    for name in PARENT:
        assert names[name] == 1, name
    # every codec span hashes: two digests of the request on its way out
    # (the body's and the client's own), one on its way in, one of the
    # frame each way
    assert names["mergetier.digest"] == 5
    assert {by_id[r["parent"]]["name"] for r in recs
            if r["name"] == "mergetier.digest"} == set(HASHING)
    # the launch runs the batched merge
    assert names["merge.materialize"] == 1
    counts = collections.Counter()
    for r in recs:
        counts.update(r["counts"])
    assert counts["mergetier.wire_bytes"] == sum(map(len, bodies)) > 0
    assert counts["mergetier.epoch_width"] == width == 1
    held = {r["name"]: r["counts"] for r in recs if r["counts"]}
    assert set(held["mergetier.launch"]) == {"mergetier.epoch_width"}
    assert held["mergetier.encode_request"] == {
        "mergetier.wire_bytes": len(bodies[0])}
    assert held["mergetier.encode_response"] == {
        "mergetier.wire_bytes": len(bodies[1])}
    assert shared >= front[1].num_ops


def test_no_profiler_no_log_but_the_registry_counts(front):
    assert not tprof.recording()
    _merge(front)
    assert tprof.span_log() == {"records": [], "dropped": 0}
    stats = tprof.span_stats("mergetier.")
    for name in (ROOT, *PARENT):
        assert stats[name]["count"] == 1, name
    assert stats["mergetier.digest"]["count"] == 5


def _fields(table):
    return {f: np.asarray(getattr(table, f)) for f in FIELDS}


def test_the_table_is_the_same_with_and_without_the_spans(front):
    bodies_off, bodies_on = [], []
    p, (off, shared, _, _) = _merge(front, bodies_off)
    with profile(activities=[ProfilerActivity.CPU]):
        _, (on, _, _, _) = _merge(front, bodies_on)
    assert tprof.span_log()["records"]
    assert bodies_on == bodies_off
    # the tier's frame is the batched merge of the candidate set, read
    # back with no tier, no wire and no span in between
    stacked, _ = mesh.stack_aligned([tpacked.with_capacity(p, shared)])
    direct = read_back(mesh.batched_materialize(stacked, device="cpu"))[0]
    want = _fields(direct)
    for table in (off, on):
        got = _fields(table)
        for f in FIELDS:
            assert got[f].dtype == want[f].dtype, f
            assert got[f].tobytes() == want[f].tobytes(), f
    assert wire.frame_digest(off) == wire.frame_digest(direct)
