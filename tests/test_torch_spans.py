"""The port's spans and counters inside the replica engine's catch-up path
(``crdt_graph_tpu_torch.utils.profiling``), on the CPU.

A small catch-up: a replica holding 64 chains of 128 adds applies a delta
that continues every chain by 32 (2,048 ops, past the bulk crossover),
then rolls it back, as the benchmark's catch-up step does.  While a
``torch.profiler`` session records, each step is one tree of span-log
records under ``engine.apply_packed``, its counts on the records; with
none, only the always-on span registry moves.
"""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crdt_graph_tpu_torch import engine as tengine
from crdt_graph_tpu_torch.codec import packed as tpacked
from crdt_graph_tpu_torch.ops import merge as tmerge
from crdt_graph_tpu_torch.utils import chainaudit
from crdt_graph_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)

CHAINS, BASE, DELTA = 64, 128, 32
STAGES = [f"merge.stage{k}" for k in range(1, 8)]
# each span's parent in a step's tree
PARENT = {
    "engine.prepare_packed": "engine.apply_packed",
    "oplog.to_packed": "engine.prepare_packed",
    "packed.concat": "engine.prepare_packed",
    "packed.ts_index": "packed.concat",
    "packed.ts_rank": "packed.concat",
    "merge.materialize": "engine.apply_packed",
    "merge.h2d": "merge.materialize",
    "packed.slot_hints": "merge.materialize",
    **{s: "merge.materialize" for s in STAGES},
    "engine.finish_packed": "engine.apply_packed",
    "engine.status_readback": "engine.finish_packed",
    "engine.commit": "engine.finish_packed",
}


def _chains(start, count):
    """Counters ``start+1 .. start+count`` of replicas 1..64's flat
    insertion chains, chain by chain, as vouched packed columns."""
    rid = np.repeat(np.arange(1, CHAINS + 1, dtype=np.int64), count)
    counter = np.tile(np.arange(start + 1, start + count + 1,
                                dtype=np.int64), CHAINS)
    ts = rid * 2**32 + counter
    anchor = np.where(counter == 1, 0, ts - 1)
    n = CHAINS * count
    idx = np.arange(n, dtype=np.int32)
    cols = {"kind": np.zeros(n, np.int8), "ts": ts,
            "parent_ts": np.zeros(n, np.int64), "anchor_ts": anchor,
            "depth": np.ones(n, np.int32), "paths": anchor[:, None].copy(),
            "value_ref": idx.copy(), "pos": idx.copy(),
            "parent_pos": np.full(n, -1, np.int32),
            "anchor_pos": np.where(counter > start + 1, idx - 1,
                                   -1).astype(np.int32),
            "target_pos": np.full(n, -1, np.int32)}
    a = tpacked.pad_arrays(cols, tpacked._bucket(n))
    return tpacked.PackedOps(
        kind=a["kind"], ts=a["ts"], parent_ts=a["parent_ts"],
        anchor_ts=a["anchor_ts"], depth=a["depth"], paths=a["paths"],
        value_ref=a["value_ref"], pos=a["pos"], values=list(range(n)),
        num_ops=n, parent_pos=a["parent_pos"], anchor_pos=a["anchor_pos"],
        target_pos=a["target_pos"], hints_vouched=True)


@pytest.fixture(scope="module")
def replica():
    """(tree holding the base, delta)."""
    t = tengine.TpuTree(9, device="cpu")
    t.apply_packed(_chains(0, BASE))
    delta = _chains(BASE, DELTA)
    assert t.packed_route(delta.num_ops)
    _step(t, delta)         # from here on each step packs the state anew
    return t, delta


@pytest.fixture(autouse=True)
def _fresh_registry(monkeypatch):
    # the suite's vouch tripwire re-derives ranks and hints inside each
    # step; the deployed path, whose tree these tests hold, runs without
    monkeypatch.delenv("GRAFT_DEBUG_VOUCH", raising=False)
    tprof.reset_spans()
    yield
    tprof.reset_spans()


def _step(t, delta, drop_index=True):
    """One catch-up step; ``drop_index``: first drop the state's cached
    timestamp index (its packing is built outside the step)."""
    if drop_index:
        t.packed_state().ts_index = None
    saved = t.begin_commit()
    t.apply_packed(delta)
    t.rollback_commit(saved)


def _trees(records):
    """{root id: records of that root}, for the ``engine.apply_packed``
    roots."""
    roots = {r["id"] for r in records
             if r["name"] == "engine.apply_packed" and r["parent"] is None}
    out = collections.defaultdict(list)
    for r in records:
        if r["root"] in roots:
            out[r["root"]].append(r)
    return out


def test_profiled_steps_log_one_tree_each(replica):
    t, delta = replica
    with profile(activities=[ProfilerActivity.CPU]):
        _step(t, delta)                   # as the benchmark steps
        _step(t, delta, drop_index=False)  # the state packed in the step
    log = tprof.span_log()
    assert log["dropped"] == 0
    trees = _trees(log["records"])
    assert len(trees) == 2
    first, second = (trees[k] for k in sorted(trees))
    for recs in (first, second):
        by_id = {r["id"]: r for r in recs}
        for r in recs:
            if r["name"] == "engine.apply_packed":
                assert r["parent"] is None and r["root"] == r["id"]
                continue
            up = by_id[r["parent"]]
            assert up["name"] == PARENT[r["name"]], r["name"]
            assert up["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= up["end_ns"]
            assert r["thread"] == up["thread"]
        names = collections.Counter(r["name"] for r in recs)
        for name in set(PARENT) - {"oplog.to_packed", "packed.ts_index"}:
            assert names[name] >= 1, name
    assert "packed.ts_index" in {r["name"] for r in first}
    assert "oplog.to_packed" in {r["name"] for r in second}
    # the packing built outside the first step is a root of its own
    outside = [r for r in log["records"] if r["name"] == "oplog.to_packed"
               and r["parent"] is None]
    assert len(outside) == 1
    assert {r["name"] for r in log["records"] if r["parent"] is None} == {
        "engine.apply_packed", "engine.rollback_commit", "oplog.to_packed"}


def test_no_profiler_no_log_but_the_registry_counts(replica):
    t, delta = replica
    assert not tprof.recording()
    _step(t, delta)
    assert tprof.span_log() == {"records": [], "dropped": 0}
    stats = tprof.span_stats()
    for name in ("engine.apply_packed", "engine.prepare_packed",
                 "packed.concat", "packed.ts_index", "packed.slot_hints",
                 "merge.materialize", "merge.h2d", "engine.finish_packed",
                 "engine.status_readback", "engine.commit",
                 "engine.rollback_commit"):
        assert stats[name]["count"] >= 1, name
    assert not any(name.startswith("merge.stage") for name in stats)
    # a count with no profiler is kept nowhere
    assert not tprof.recording()
    tprof.count("packed.index_rows", 5)
    assert tprof.span_log() == {"records": [], "dropped": 0}


def test_index_counters_count_the_base_adds_and_the_chain_heads(replica):
    t, delta = replica
    with profile(activities=[ProfilerActivity.CPU]):
        _step(t, delta)
    recs = tprof.span_log()["records"]
    (index,) = [r for r in recs if r["name"] == "packed.ts_index"]
    assert index["counts"] == {"packed.index_rows": CHAINS * BASE}
    (concat,) = [r for r in recs if r["name"] == "packed.concat"]
    assert concat["counts"] == {"packed.index_lookups": CHAINS}
    counted = collections.Counter()
    for r in recs:
        counted.update(r["counts"])
    assert set(counted) == {"packed.index_rows", "packed.index_lookups",
                            "convert.h2d_bytes", "merge.slot_hints_on_card"}
    assert counted["packed.index_rows"] == CHAINS * BASE
    assert counted["packed.index_lookups"] == CHAINS


@pytest.mark.parametrize("s_cap", [None, "1024"])
def test_each_step_derives_its_slot_hints_on_the_device(replica, s_cap,
                                                        monkeypatch):
    """One derivation a step, after the copy, and its crowd columns
    (derived where the merge sorts siblings on the compacted branch, as
    with a sort width of 1,024) verified: no refusal, one counted read."""
    if s_cap is not None:
        monkeypatch.setenv("GRAFT_S_CAP", s_cap)
    t, delta = replica
    syncs0 = tmerge.host_syncs
    _step(t, delta)
    plain_reads = tmerge.host_syncs - syncs0
    with profile(activities=[ProfilerActivity.CPU]):
        _step(t, delta)
        _step(t, delta)
    recs = tprof.span_log()["records"]
    hints = [r for r in recs if r["name"] == "packed.slot_hints"]
    assert len(hints) == 2
    assert all(r["counts"] == {"merge.slot_hints_on_card": 1}
               for r in hints)
    assert not any("merge.crowd_hints_refused" in r["counts"] for r in recs)
    h2d = {r["id"]: r for r in recs if r["name"] == "merge.h2d"}
    for r in hints:
        first_stage = min((x for x in recs if x["parent"] == r["parent"]
                           and x["name"].startswith("merge.stage")),
                          key=lambda x: x["start_ns"])
        (copy,) = [x for x in h2d.values() if x["parent"] == r["parent"]]
        assert copy["end_ns"] <= r["start_ns"] <= r["end_ns"] \
            <= first_stage["start_ns"]
    syncs0 = tmerge.host_syncs
    with chainaudit.Audit() as a:
        _step(t, delta)
    assert tmerge.host_syncs - syncs0 == plain_reads
    res = a.result()
    assert res.derived == 1
    assert res.summary()["ok"]
    # the crowd columns' verification is the derivation's one read
    hint_reads = [x for x in res.rows if x[4] == "hints"
                  and x[1].endswith("[read]")]
    assert len(hint_reads) == (1 if s_cap else 0)


def test_h2d_bytes_are_the_columns_the_leg_sends(replica):
    t, delta = replica
    cand = tpacked.concat(t.packed_state(), delta)
    assert tengine._mode(cand) == "exhaustive"
    # the link and rank columns (the rank leg's): the slot leg derives
    # the slot hints it is not given after the copy
    cols = cand.columns()
    assert tmerge.select_leg(cols, tengine._mode(cand)) == "slot"
    sent = sum(cols[k].nbytes for k in tmerge.LEG_COLS["rank"])
    arrs = cand.arrays()
    assert sent < sum(arrs[k].nbytes for k in tmerge.LEG_COLS["slot"])
    tprof.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        _step(t, delta)
    recs = tprof.span_log()["records"]
    (h2d,) = [r for r in recs if r["name"] == "merge.h2d"]
    assert h2d["counts"] == {"convert.h2d_bytes": sent}
    assert sum(r["counts"].get("convert.h2d_bytes", 0)
               for r in recs) == sent


def test_records_lie_on_the_profilers_clock(replica):
    t, delta = replica
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(t, delta)
    events = collections.defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            events[ev.name()].append(ev.start_ns())
    starts = collections.defaultdict(list)
    for r in tprof.span_log()["records"]:
        starts[r["name"]].append(r["start_ns"])
    assert len(starts) >= len(PARENT) + 1
    for name, ours in starts.items():
        theirs = sorted(events[name])
        assert len(theirs) == len(ours), name
        for a, b in zip(sorted(ours), theirs):
            assert abs(a - b) < 1_000_000, (name, a - b)


def test_ring_drops_the_oldest_and_counts(monkeypatch):
    monkeypatch.setattr(tprof, "_ring", collections.deque(maxlen=4))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(6):
            with tprof.span(f"t.{i}"):
                tprof.count("t.n", i)
    log = tprof.span_log()
    assert [r["name"] for r in log["records"]] == ["t.2", "t.3", "t.4",
                                                   "t.5"]
    assert [r["counts"] for r in log["records"]] == [
        {"t.n": i} for i in range(2, 6)]
    assert log["dropped"] == 2
    assert tprof.span_stats("t.")["t.0"]["count"] == 1
    tprof.reset_spans()
    assert tprof.span_log() == {"records": [], "dropped": 0}
    assert tprof.span_stats() == {}


def test_phases_end_where_the_next_begins():
    tprof.phase("t.off")            # no profiler: nothing opens
    tprof.phase(None)
    with profile(activities=[ProfilerActivity.CPU]):
        with tprof.span("t.outer"):
            tprof.phase("t.a")
            tprof.count("t.n", 2)
            tprof.phase("t.b")
            with tprof.span("t.inner"):
                pass
            tprof.phase(None)
    recs = {r["name"]: r for r in tprof.span_log()["records"]}
    assert set(recs) == {"t.outer", "t.a", "t.b", "t.inner"}
    outer, a, b = recs["t.outer"], recs["t.a"], recs["t.b"]
    assert a["parent"] == b["parent"] == outer["id"]
    assert recs["t.inner"]["parent"] == b["id"]
    assert a["end_ns"] <= b["start_ns"] and b["end_ns"] <= outer["end_ns"]
    assert a["counts"] == {"t.n": 2} and outer["counts"] == {}
    assert "t.a" not in tprof.span_stats()


def test_stage_spans_follow_the_audit_markers(replica):
    t, delta = replica
    with profile(activities=[ProfilerActivity.CPU]):
        _step(t, delta)
    recs = tprof.span_log()["records"]
    (mat,) = [r for r in recs if r["name"] == "merge.materialize"]
    stages = sorted((r for r in recs if r["parent"] == mat["id"]
                     and r["name"].startswith("merge.stage")),
                    key=lambda r: r["start_ns"])
    assert [r["name"] for r in stages] == STAGES
    for a, b in zip(stages, stages[1:]):
        assert a["end_ns"] <= b["start_ns"]
    # an audit reads the same stages with the profiler on as off
    with chainaudit.Audit() as plain:
        _step(t, delta)
    with profile(activities=[ProfilerActivity.CPU]):
        with chainaudit.Audit() as traced:
            _step(t, delta)
    assert traced.result().by_stage() == plain.result().by_stage()
    got = [r["name"] for r in tprof.span_log()["records"]
           if r["name"].startswith("merge.stage")]
    assert got == STAGES * 2
