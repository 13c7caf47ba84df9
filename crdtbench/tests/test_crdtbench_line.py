"""The run's output: the last line of standard output is the contract's
one JSON object, the numbers compared are the last lines of standard
error, and every metric is one the cell lists."""
import json

import pytest

from crdtbench import run
from crdtbench.tests.conftest import TINY


def _listed(root, workload, key):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return {m["name"]: m["unit"] for m in bench[key]
            if "workloads" not in m or workload in m["workloads"]}


@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("workload", sorted(TINY))
def test_last_line(workload, trace, root, capsys):
    rc = run.main(["--workload", workload, "--seed", str(2**31 + 11),
                   "--seconds", "1.5", "--trace", str(trace)],
                  device="cpu", root=root, adjust=TINY[workload])
    assert rc == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    listed = _listed(root, workload, "per_layer" if trace else "end_to_end")
    for name, m in line["metrics"].items():
        assert m["unit"] == listed[name]
        assert isinstance(m["value"], float | int)
    if not trace:
        assert set(line["metrics"]) == set(listed)
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert 0 < len(line["breakdown"]["idle_gaps"]) <= 10
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    for t in tail:
        _, name, value, _, limit = t.split()
        assert line["checks"][name] == {"value": int(value),
                                        "limit": int(limit)}


def test_no_card_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "rga64x1M.catchup", "--seed", "1",
                   "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out.strip() == ""
    assert "CUDA" in err


def test_the_repository_lists_the_catchup_cell(root):
    spec = run.load_cell(root, "rga64x1M.catchup")
    assert spec["traffic"]["driver"] == "catchup"
    assert {m["name"] for m in spec["end_to_end"]} == {
        "merged_ops_per_s", "merge_p50_ms", "setup_s"}


def test_trace_covers_a_fixed_sub_window(root, capsys, monkeypatch):
    from crdtbench import trace
    monkeypatch.setattr(trace, "SECONDS", 0.3)
    rc = run.main(["--workload", "rga64x1M.catchup", "--seed", "77",
                   "--seconds", "2", "--trace", "1"],
                  device="cpu", root=root,
                  adjust=TINY["rga64x1M.catchup"])
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert 0.3 <= line["device"]["window_s"] < 1.5
    assert "traced" in err


@pytest.mark.parametrize("events,quiet,stopped", (
    (0, 0.0, True), (900, 12.0, True), (900, 0.4, False)))
def test_a_trace_that_stops_early_is_refused(events, quiet, stopped):
    from crdtbench.trace import stopped_recording
    assert stopped_recording({"device_events": events,
                              "quiet_tail_s": quiet}) is stopped


def test_unknown_workload_exits():
    with pytest.raises(SystemExit):
        run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"],
                 device="cpu")
