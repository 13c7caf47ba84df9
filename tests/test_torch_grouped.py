"""The replica engine's grouped merge (``engine.apply_packed_grouped``):
several documents caught up in one batched merge, on the CPU.

Three documents with disjoint replica ids, different base and delta
sizes (so the smaller candidate sets are padded to the shared
capacity), one of them an outline nested three deep (so the flat
documents' path planes are widened).  Each candidate set is built in
its row of the round's column frame; the stack handed to the merge, and
each document's parked candidate set, equal what
``mesh.stack_aligned`` makes of the separately built sets.  Each
document's committed state equals the same delta applied alone by
``apply_packed`` on a twin replica, table field for field, also when a
second round merges on the row views the first parked, and its order
equals the plain reference's; a rejected document is left as it was
while the others commit; one call is one span tree; and the serving
scheduler's cross-document round goes through this one call.
"""
import threading
import time

import numpy as np
import pytest
import torch

from crdt_graph_tpu_torch import engine
from crdt_graph_tpu_torch.codec import json_codec as tjson
from crdt_graph_tpu_torch.core.errors import CRDTError
from crdt_graph_tpu_torch.core.operation import Add, Batch
from crdt_graph_tpu_torch.obs.flight import FlightRecorder
from crdt_graph_tpu_torch.ops.merge import FIELDS
from crdt_graph_tpu_torch.parallel import mesh
from crdt_graph_tpu_torch.serve import ServingEngine
from crdt_graph_tpu_torch.utils import profiling
from crdtbench.drivers import packed_of
from crdtbench.drivers.grouped import shifted
from crdtbench.gen import chains, nested, rng_for
from crdtbench.reference import check as check_mod

torch.set_num_threads(1)

OFF = 2**32
LOCAL = 99          # every replica's own id; it sends no ops
# the fields that hold slots: the null slot (the last) differs with the
# capacity a table was merged at
SLOT_FIELDS = ("parent", "order", "visible_order")


def _flat(seed, replicas, first, base, *deltas):
    """(base cols, base values, then each delta's cols and values) of
    interleaved chains from replicas ``first + 1 .. first + replicas``,
    each delta continuing the chains."""
    per = base // replicas
    bc, bv = chains.chain_rows(rng_for(seed, 1), replicas, 0, per)
    out = [shifted(bc, first), bv]
    for j, delta in enumerate(deltas):
        dc, dv = chains.chain_rows(rng_for(seed, 2 + j), replicas, per,
                                   delta // replicas)
        per += delta // replicas
        out += [shifted(dc, first), dv]
    return tuple(out)


def _outline(seed, replicas, first, depth, base, *deltas):
    """The same for a nested outline ``depth`` deep."""
    bc, bv = nested.nested_rows(rng_for(seed, 1), replicas, depth,
                                np.zeros(replicas, np.int64), base)
    out, seen = [shifted(bc, first), bv], [bc["ts"]]
    for j, delta in enumerate(deltas):
        after = nested.counters_after({"ts": np.concatenate(seen)},
                                      replicas)
        dc, dv = nested.nested_rows(rng_for(seed, 2 + j), replicas, depth,
                                    after, delta)
        seen.append(dc["ts"])
        out += [shifted(dc, first), dv]
    return tuple(out)


# candidate sets of 3,100, 6,200 and 4,608 rows: capacities 4,096,
# 8,192 and 8,192; path widths 1, 1 and the outline's
DOCS = [_flat(11, 4, 0, 2000, 1100),
        _flat(12, 4, 4, 5000, 1200),
        _outline(13, 3, 8, 3, 3072, 1536)]
# the same documents, each with a second delta after the first
TWICE = [_flat(11, 4, 0, 2000, 1100, 1100),
         _flat(12, 4, 4, 5000, 1200, 1200),
         _outline(13, 3, 8, 3, 3072, 1536, 1536)]
# a document whose replica starts with an empty log: its candidate set
# is the delta alone (2,048 rows), which the union does not copy
FRESH = _flat(14, 4, 12, 0, 1200)


def _replica(doc):
    tree = engine.TpuTree(LOCAL, device="cpu")
    if doc is FRESH:
        return tree
    tree.apply_packed(packed_of(doc[0], doc[1]))
    return tree


def _delta(doc, j=0):
    """The document's ``j``-th delta (its first by default)."""
    return packed_of(doc[2 + 2 * j], doc[3 + 2 * j])


def _prepared(doc):
    """The document's candidate set, as the grouped merge stacks it."""
    return _replica(doc).prepare_packed(_delta(doc))


def _state(tree):
    """What a replica's content fingerprint hashes: clocks, log extent
    and the visible sequence."""
    return (tree.log_length, tree.timestamp, sorted(tree._replicas.items()),
            tree.visible_values())


def _host(x) -> np.ndarray:
    """A table field as a host array (a replica's read turns its parked
    device table into host arrays)."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _canonical(table, slots):
    """The table's first ``slots`` slots (the root and the nodes), with
    the null slot read as -1, and its statuses."""
    null = int(table.ts.shape[0]) - 1
    out = {}
    for f in FIELDS:
        x = _host(getattr(table, f))
        if f in SLOT_FIELDS:
            x = np.where(x == null, -1, x)
        if f == "status":
            x = x[:slots - 1]
        elif x.ndim:
            x = x[:slots]
        out[f] = x
    return out


@pytest.fixture(scope="module")
def grouped():
    trees = [_replica(d) for d in DOCS]
    errors = engine.apply_packed_grouped(trees, [_delta(d) for d in DOCS])
    return trees, errors


def test_the_documents_need_realigning():
    caps = {_prepared(d).capacity for d in DOCS}
    widths = {_prepared(d).paths.shape[1] for d in DOCS}
    assert len(caps) == 2 and len(widths) == 2


def _assert_same(got, want):
    """``got``'s state and table equal ``want``'s (a table of a larger
    capacity holds no node past the smaller's, and its flat path planes
    may be widened with zeros)."""
    assert _state(got) == _state(want)
    assert got.last_applied_mask.tolist() == want.last_applied_mask.tolist()
    slots = min(got._table.ts.shape[0], want._table.ts.shape[0]) - 1
    a, b = _canonical(got._table, slots), _canonical(want._table, slots)
    # the stack widened the flat documents' path planes with zeros
    width = b["paths"].shape[1]
    assert not a["paths"][:, width:].any()
    a["paths"] = a["paths"][:, :width]
    for f in FIELDS:
        assert np.array_equal(a[f], b[f]), f
    # the rows past the smaller capacity hold no node
    assert not _host(got._table.exists)[slots:].any()


@pytest.mark.parametrize("i", range(len(DOCS)))
def test_each_document_equals_its_own_apply_packed(grouped, i):
    trees, errors = grouped
    assert errors == [None] * len(DOCS)
    twin = _replica(DOCS[i])
    twin.apply_packed(_delta(DOCS[i]))
    _assert_same(trees[i], twin)


@pytest.mark.parametrize("docs", [DOCS, DOCS + [FRESH]],
                         ids=["docs", "docs+fresh"])
def test_the_frame_is_the_stack_of_the_candidate_sets(monkeypatch, docs):
    """The stack the merge gets, and each document's parked candidate
    set, equal ``stack_aligned`` of the candidate sets built apart."""
    want, aligned = mesh.stack_aligned(
        [_replica(d).prepare_packed(_delta(d)) for d in docs])
    seen = []
    orig = mesh.batched_materialize

    def spy(ops, **kw):
        seen.append(ops)
        return orig(ops, **kw)
    monkeypatch.setattr(mesh, "batched_materialize", spy)
    trees = [_replica(d) for d in docs]
    errors = engine.apply_packed_grouped(trees, [_delta(d) for d in docs])
    assert errors == [None] * len(docs) and len(seen) == 1
    got = seen[0]
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for t, a in zip(trees, aligned):
        p = t._packed
        assert p.kind.base is got["kind"]
        for k, col in a.columns().items():
            assert getattr(p, k).shape == col.shape, k
            assert getattr(p, k).dtype == col.dtype, k
            np.testing.assert_array_equal(getattr(p, k), col, err_msg=k)
        assert p.values == a.values
        assert (p.num_ops, p.hints_vouched) == (a.num_ops, a.hints_vouched)


def test_a_second_round_merges_on_the_rows_the_first_parked():
    trees = [_replica(d) for d in TWICE]
    for j in range(2):
        errors = engine.apply_packed_grouped(
            trees, [_delta(d, j) for d in TWICE])
        assert errors == [None] * len(TWICE)
    for t, d in zip(trees, TWICE):
        twin = _replica(d)
        twin.apply_packed(_delta(d, 0))
        twin.apply_packed(_delta(d, 1))
        _assert_same(t, twin)


def test_a_rejected_document_merges_in_the_next_round():
    trees = [_replica(d) for d in TWICE]
    errors = engine.apply_packed_grouped(
        trees, [_delta(TWICE[0]), _rejected(), _delta(TWICE[2])])
    assert isinstance(errors[1], CRDTError)
    errors = engine.apply_packed_grouped(
        trees, [_delta(TWICE[0], 1), _delta(TWICE[1]), _delta(TWICE[2], 1)])
    assert errors == [None] * len(TWICE)
    for i, (t, d) in enumerate(zip(trees, TWICE)):
        twin = _replica(d)
        twin.apply_packed(_delta(d))
        if i != 1:
            twin.apply_packed(_delta(d, 1))
        _assert_same(t, twin)


@pytest.mark.parametrize("i", range(len(DOCS)))
def test_each_document_equals_the_reference(grouped, i):
    trees, _ = grouped
    t = trees[i]._table
    doc = DOCS[i]
    cols = {f: np.concatenate([doc[0][f], doc[2][f]])
            for f in ("kind", "ts", "depth", "paths")}
    n = int(cols["ts"].shape[0])
    got = check_mod.table_view(
        *(_host(getattr(t, f)) for f in ("ts", "visible_order",
                                         "num_visible", "depth", "parent",
                                         "status")), n)
    assert check_mod.judge(got, cols, n) == {
        "order_mismatches": 0, "shape_mismatches": 0,
        "status_mismatches": 0}


def _rejected():
    """The second document's delta with one op anchored at an op no
    replica made."""
    bad = dict(DOCS[1][2])
    # row 0 is a chain's first op in the batch whose anchor lies in the
    # base: point it at an op no replica made
    k = int(np.nonzero(bad["anchor_pos"] < 0)[0][0])
    for f in ("anchor_ts", "paths"):
        bad[f] = bad[f].copy()
    missing = 77 * OFF + 5
    bad["anchor_ts"][k] = missing
    bad["paths"][k, 0] = missing
    return packed_of(bad, DOCS[1][3])


def test_a_rejected_document_is_left_untouched():
    trees = [_replica(d) for d in DOCS]
    before = [_state(t) for t in trees]
    deltas = [_delta(DOCS[0]), _rejected(), _delta(DOCS[2])]
    errors = engine.apply_packed_grouped(trees, deltas)
    assert errors[0] is None and errors[2] is None
    assert isinstance(errors[1], CRDTError)
    assert _state(trees[1]) == before[1]
    for i in (0, 2):
        twin = _replica(DOCS[i])
        twin.apply_packed(_delta(DOCS[i]))
        assert _state(trees[i]) == _state(twin)


def test_bad_calls_raise_before_anything_runs(monkeypatch):
    trees = [_replica(d) for d in DOCS[:2]]
    before = [_state(t) for t in trees]
    small = packed_of({k: v[:64] for k, v in DOCS[1][2].items()},
                      DOCS[1][3][:64])
    ran = []
    monkeypatch.setattr(mesh, "batched_materialize",
                        lambda *a, **kw: ran.append(1))
    with pytest.raises(ValueError):
        engine.apply_packed_grouped(trees, [_delta(DOCS[0]), small])
    with pytest.raises(ValueError):
        engine.apply_packed_grouped(trees, [_delta(DOCS[0])])
    assert ran == [] and [_state(t) for t in trees] == before


def test_a_failed_launch_commits_nothing(monkeypatch):
    trees = [_replica(d) for d in DOCS]
    before = [_state(t) for t in trees]

    def broken(*a, **kw):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(mesh, "batched_materialize", broken)
    with pytest.raises(RuntimeError):
        engine.apply_packed_grouped(trees, [_delta(d) for d in DOCS])
    assert [_state(t) for t in trees] == before


def test_one_call_is_one_span_tree():
    trees = [_replica(d) for d in DOCS]
    deltas = [_delta(d) for d in DOCS]
    profiling.reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        engine.apply_packed_grouped(trees, deltas)
    recs = profiling.span_log()["records"]
    roots = [r for r in recs if r["name"] == "engine.apply_grouped"
             and r["parent"] is None]
    assert len(roots) == 1
    kids = sorted((r for r in recs if r["parent"] == roots[0]["id"]),
                  key=lambda r: r["start_ns"])
    names = [r["name"] for r in kids]
    b = len(DOCS)
    assert names == (["engine.prepare_packed"] * b + ["grouped.stack",
                     "merge.materialize"] + ["engine.finish_packed"] * b)
    stack = kids[b]
    cap = max(t._table.capacity for t in trees)
    live = sum(t.log_length for t in trees)
    assert stack["counts"] == {"grouped.docs": b,
                               "grouped.rows_stacked": b * cap,
                               "grouped.rows_live": live,
                               "grouped.rows_in_place": live,
                               "grouped.rows_restacked": 0}
    merge_kids = {r["name"] for r in recs if r["parent"] == kids[b + 1]["id"]}
    assert "merge.h2d" in merge_kids


def _body(rid, n):
    ops, prev = [], 0
    for c in range(1, n + 1):
        ts = rid * OFF + c
        ops.append(Add(ts, (prev,), f"{rid}.{c}"))
        prev = ts
    return tjson.dumps(Batch(tuple(ops)))


def test_a_serving_round_goes_through_the_engine_call(monkeypatch):
    monkeypatch.setenv("GRAFT_OBS_AUDIT_EVERY", "0")
    calls = []
    orig = engine.apply_packed_grouped

    def spy(trees, deltas, **kw):
        calls.append([d.num_ops for d in deltas])
        return orig(trees, deltas, **kw)
    monkeypatch.setattr(engine, "apply_packed_grouped", spy)
    eng = ServingEngine(start=False, cross_doc=True, device="cpu",
                        flight=FlightRecorder(), submit_timeout_s=60.0)
    pushes = [(f"g{i}", _body(i + 2, 1500 + 100 * i)) for i in range(3)]
    try:
        boxes = []
        for doc_id, b in pushes:
            eng.get(doc_id)
            box = {}

            def go(d=doc_id, b=b, box=box):
                box["r"] = eng.submit(d, b)
            th = threading.Thread(target=go, daemon=True)
            th.start()
            boxes.append((th, box))
        deadline = time.monotonic() + 30
        for doc_id, _ in pushes:
            while len(eng.get(doc_id).queue) < 1:
                assert time.monotonic() < deadline, "push never queued"
                time.sleep(0.002)
        assert eng.scheduler.step() == len(pushes)
        for th, box in boxes:
            th.join(30)
            assert box["r"][0]
        assert calls == [[1500, 1600, 1700]]
        assert eng.counters.get("cross_doc_batches") == 1
        assert eng.counters.get("cross_doc_docs") == 3
        for rec in eng.flight.records():
            assert rec.batch_width == 3
            assert {"batch_prepare", "batched_launch", "merge"} \
                <= set(rec.stages_ms)
        for i, (doc_id, _) in enumerate(pushes):
            tree = eng.get(doc_id).tree
            assert tree.log_length == 1500 + 100 * i
            assert tree.visible_values()[-1] == f"{i + 2}.{1500 + 100 * i}"
    finally:
        eng.close()
