"""The readers of the program's span log (``crdt_graph_tpu_torch.utils.
profiling.span_log``), on a synthetic log of two traced steps: each
reads its spans and counters inside the steps' trees only, and returns
nothing for a log it cannot trust."""
import pytest

from crdt_graph_tpu_torch.utils import profiling
from crdtbench import run

MS = 1_000_000
READERS = ("ts_index_ms_per_step", "concat_ms_per_step",
           "index_rows_per_lookup", "slot_hints_ms_per_step",
           "merge_host_ms_per_step", "commit_ms_per_step",
           "h2d_bytes_per_op")


def _step(first_id, t0, index_ms, concat_ms, hints_ms, merge_ms,
          commit_ms, rows, lookups, sent):
    """One step's tree: (name, parent offset or None, start ms, end ms,
    counts) from ``t0``; ids count up from ``first_id``."""
    prep = 5 + concat_ms + index_ms
    spans = [
        ("engine.apply_packed", None, 0, prep + hints_ms + merge_ms
         + commit_ms, {}),
        ("engine.prepare_packed", 0, 0, prep, {}),
        ("packed.concat", 1, 2, 2 + concat_ms + index_ms,
         {"packed.index_lookups": lookups}),
        ("packed.ts_index", 2, 3, 3 + index_ms,
         {"packed.index_rows": rows}),
        ("packed.ts_rank", 2, 3 + index_ms, 4 + index_ms, {}),
        ("packed.slot_hints", 0, prep, prep + hints_ms, {}),
        ("merge.materialize", 0, prep + hints_ms,
         prep + hints_ms + merge_ms, {}),
        ("merge.h2d", 6, prep + hints_ms, prep + hints_ms + 1,
         {"convert.h2d_bytes": sent}),
        ("engine.finish_packed", 0, prep + hints_ms + merge_ms,
         prep + hints_ms + merge_ms + commit_ms, {}),
    ]
    out = []
    for i, (name, up, a, b, counts) in enumerate(spans):
        out.append({"name": name, "id": first_id + i,
                    "parent": None if up is None else first_id + up,
                    "root": first_id, "thread": 1,
                    "start_ns": t0 + a * MS, "end_ns": t0 + b * MS,
                    "counts": counts})
    return out


def _outside(first_id, t0):
    """Roots outside the steps: the state's packing (with a concat and an
    index of its own) and a rollback."""
    return [
        {"name": "oplog.to_packed", "id": first_id, "parent": None,
         "root": first_id, "thread": 1, "start_ns": t0,
         "end_ns": t0 + 50 * MS, "counts": {}},
        {"name": "packed.concat", "id": first_id + 1, "parent": first_id,
         "root": first_id, "thread": 1, "start_ns": t0 + MS,
         "end_ns": t0 + 40 * MS, "counts": {"packed.index_lookups": 7}},
        {"name": "packed.ts_index", "id": first_id + 2,
         "parent": first_id + 1, "root": first_id, "thread": 1,
         "start_ns": t0 + 2 * MS, "end_ns": t0 + 30 * MS,
         "counts": {"packed.index_rows": 9}},
        {"name": "engine.rollback_commit", "id": first_id + 3,
         "parent": None, "root": first_id + 3, "thread": 1,
         "start_ns": t0 + 60 * MS, "end_ns": t0 + 61 * MS, "counts": {}},
    ]


def _log():
    return (_outside(1, 0)
            + _step(10, 100 * MS, index_ms=600, concat_ms=150,
                    hints_ms=400, merge_ms=40, commit_ms=20, rows=1000,
                    lookups=4, sent=7000)
            + _outside(20, 2000 * MS)
            + _step(30, 3000 * MS, index_ms=500, concat_ms=250,
                    hints_ms=500, merge_ms=60, commit_ms=10, rows=1000,
                    lookups=4, sent=9000))


WANT = {
    # (600 + 500) / 2
    "ts_index_ms_per_step": 550.0,
    # the concat spans less their index children: (150 + 250) / 2
    "concat_ms_per_step": 200.0,
    # (1000 + 1000) / (4 + 4)
    "index_rows_per_lookup": 250.0,
    "slot_hints_ms_per_step": 450.0,
    "merge_host_ms_per_step": 50.0,
    "commit_ms_per_step": 15.0,
    # (7000 + 9000) / (1000 + 3000)
    "h2d_bytes_per_op": 4.0,
}


def _rec(steps=2):
    return {"window": {"traced_ops": [1000, 3000][:steps]}}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_steps(name, monkeypatch):
    monkeypatch.setattr(profiling, "span_log",
                        lambda: {"records": _log(), "dropped": 0})
    assert run.read_metric(name, _rec()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("case", ("empty", "dropped", "steps",
                                  "no span log"))
@pytest.mark.parametrize("name", READERS)
def test_reader_returns_nothing_for_a_log_it_cannot_trust(name, case,
                                                          monkeypatch):
    log = {"records": [] if case == "empty" else _log(),
           "dropped": 1 if case == "dropped" else 0}
    if case == "no span log":       # a program without one
        monkeypatch.delattr(profiling, "span_log")
    else:
        monkeypatch.setattr(profiling, "span_log", lambda: log)
    rec = _rec(1 if case == "steps" else 2)
    assert run.read_metric(name, rec) is None


def test_every_reader_is_listed_for_the_catchup_cell(root):
    spec = run.load_cell(root, "rga64x1M.catchup")
    listed = {m["name"]: m for m in spec["per_layer"]}
    for name in READERS:
        assert listed[name]["source"] == "program_counter"
        assert listed[name]["moves"] == "merged_ops_per_s"


def test_a_reader_of_another_path_names_its_root(monkeypatch):
    from crdtbench import spanlog
    log = [dict(r, name="tier.merge") if r["parent"] is None
           and r["name"] == spanlog.STEP else r for r in _log()]
    monkeypatch.setattr(profiling, "span_log",
                        lambda: {"records": log, "dropped": 0})
    assert spanlog.ms_per_step(_rec(), "merge.materialize") is None
    assert spanlog.ms_per_step(_rec(), "merge.materialize",
                               root="tier.merge") == pytest.approx(50.0)
