"""The grouped cell's readers of the program's span log, on a synthetic
log of two traced grouped steps: each reads its spans and counts inside
the ``engine.apply_grouped`` trees only, and returns nothing for a log
it cannot trust; and a batched table whose documents' slices are
exchanged reads not correct."""
import json

import pytest

from crdt_graph_tpu_torch.utils import profiling
from crdtbench import run
from crdtbench.tests.conftest import TINY, faults_of

MS = 1_000_000
ROOT = "engine.apply_grouped"
READERS = ("grouped_prepare_ms_per_step", "grouped_stack_ms_per_step",
           "grouped_pad_share", "grouped_merge_ms_per_step",
           "grouped_finish_ms_per_step")


def _step(first_id, t0, docs, prep_ms, stack_ms, merge_ms, finish_ms,
          live, stacked):
    """One grouped step's tree from ``t0``: ``docs`` prepares, the stack
    with its counts, the merge, ``docs`` finishes; ids count up from
    ``first_id``."""
    spans = [(ROOT, None, 0, docs * (prep_ms + finish_ms) + stack_ms
              + merge_ms, {})]
    t = 0
    for _ in range(docs):
        spans.append(("engine.prepare_packed", 0, t, t + prep_ms, {}))
        spans.append(("packed.concat", len(spans) - 1, t, t + prep_ms, {}))
        t += prep_ms
    spans.append(("grouped.stack", 0, t, t + stack_ms,
                  {"grouped.docs": docs, "grouped.rows_live": live,
                   "grouped.rows_stacked": stacked}))
    t += stack_ms
    spans.append(("merge.materialize", 0, t, t + merge_ms, {}))
    spans.append(("merge.h2d", len(spans) - 1, t, t + 1, {}))
    t += merge_ms
    for _ in range(docs):
        spans.append(("engine.finish_packed", 0, t, t + finish_ms, {}))
        t += finish_ms
    out = []
    for i, (name, up, a, b, counts) in enumerate(spans):
        out.append({"name": name, "id": first_id + i,
                    "parent": None if up is None else first_id + up,
                    "root": first_id, "thread": 1,
                    "start_ns": t0 + a * MS, "end_ns": t0 + b * MS,
                    "counts": counts})
    return out


def _outside(first_id, t0):
    """Roots outside the steps: a warm catch-up merge with spans of the
    same names and a stack count, and a rollback."""
    names = ("engine.prepare_packed", "grouped.stack", "merge.materialize",
             "engine.finish_packed")
    out = [{"name": "engine.apply_packed", "id": first_id, "parent": None,
            "root": first_id, "thread": 1, "start_ns": t0,
            "end_ns": t0 + 900 * MS, "counts": {}}]
    for i, name in enumerate(names):
        out.append({"name": name, "id": first_id + 1 + i,
                    "parent": first_id, "root": first_id, "thread": 1,
                    "start_ns": t0 + 100 * i * MS,
                    "end_ns": t0 + (100 * i + 90) * MS,
                    "counts": {"grouped.rows_live": 1,
                               "grouped.rows_stacked": 1000}})
    out.append({"name": "engine.rollback_commit", "id": first_id + 9,
                "parent": None, "root": first_id + 9, "thread": 1,
                "start_ns": t0 + 950 * MS, "end_ns": t0 + 951 * MS,
                "counts": {}})
    return out


def _log():
    return (_outside(1, 0)
            + _step(20, 1000 * MS, docs=3, prep_ms=100, stack_ms=30,
                    merge_ms=400, finish_ms=10, live=300, stacked=600)
            + _outside(50, 4000 * MS)
            + _step(80, 6000 * MS, docs=3, prep_ms=120, stack_ms=50,
                    merge_ms=500, finish_ms=20, live=500, stacked=600))


WANT = {
    # 3 x (100 + 120) / 2
    "grouped_prepare_ms_per_step": 330.0,
    "grouped_stack_ms_per_step": 40.0,
    # 100 x (1 - (300 + 500) / (600 + 600))
    "grouped_pad_share": 100.0 / 3.0,
    "grouped_merge_ms_per_step": 450.0,
    # 3 x (10 + 20) / 2
    "grouped_finish_ms_per_step": 45.0,
}


def _rec(steps=2):
    return {"window": {"traced_ops": [1200, 1200][:steps]}}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_grouped_steps(name, monkeypatch):
    monkeypatch.setattr(profiling, "span_log",
                        lambda: {"records": _log(), "dropped": 0})
    assert run.read_metric(name, _rec()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("case", ("empty", "dropped", "steps",
                                  "no span log", "other root"))
@pytest.mark.parametrize("name", READERS)
def test_reader_returns_nothing_for_a_log_it_cannot_trust(name, case,
                                                          monkeypatch):
    records = [] if case == "empty" else _log()
    if case == "other root":        # a program without the grouped call
        records = [dict(r, name="serve.grouped") if r["name"] == ROOT
                   else r for r in records]
    log = {"records": records, "dropped": 1 if case == "dropped" else 0}
    if case == "no span log":
        monkeypatch.delattr(profiling, "span_log")
    else:
        monkeypatch.setattr(profiling, "span_log", lambda: log)
    rec = _rec(1 if case == "steps" else 2)
    assert run.read_metric(name, rec) is None


def test_every_reader_is_listed_for_the_grouped_cell(root):
    spec = run.load_cell(root, "docs8x1M.grouped")
    listed = {m["name"]: m for m in spec["per_layer"]}
    for name in READERS + ("grouped_dispatches_per_merge",
                           "grouped_kernels_roofline"):
        assert listed[name]["moves"] == "merged_ops_per_s"
        assert listed[name]["workloads"] == ["docs8x1M.grouped"]


def test_exchanged_document_slices_are_not_correct(root, monkeypatch,
                                                   capsys):
    faults_of("grouped")["swapped"](monkeypatch)
    rc = run.main(["--workload", "docs8x1M.grouped", "--seed", "2147483659",
                   "--seconds", "1", "--trace", "0"],
                  device="cpu", root=root, adjust=TINY["docs8x1M.grouped"])
    out, _ = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False
    # the documents share no timestamp: a slice read from the wrong
    # document mismatches in order
    assert line["checks"]["order_mismatches"]["value"] > 0
