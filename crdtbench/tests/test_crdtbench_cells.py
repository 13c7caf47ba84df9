"""A cell is new files and entries only: every cell ``BENCHMARK.json``
lists has the files its runs and tests read, and a cell added as
entries to a copy of ``BENCHMARK.json`` with files of its own in a
throwaway root runs, traced and untraced, and drives the control,
without a file of the checkout written or edited."""
import json

import pytest

from crdtbench import control, run
from crdtbench.tests.conftest import (ROOT, incomplete, listed,
                                      tiny_sizes)


@pytest.mark.parametrize("workload", listed())
def test_every_cell_is_complete(workload, root):
    assert incomplete(root, workload) == []


NEW = "rga4x64k.catchup"
CONFIG = {"name": "rga4x64k", "replicas": 4, "ops": 65536, "depth": 1,
          "add_share": 1.0, "local_replica": 5}
TRAFFIC = {"driver": "catchup", "delta_ops": [16384, 24576],
           "checked_steps": 2}
TINY_FILE = {"config": {"ops": 4096},
             "traffic": {"delta_ops": [1024, 2048]}}


def _checkout():
    """Each file of the checkout's harness and cells, with its bytes."""
    files = [ROOT / "BENCHMARK.json", *(
        p for p in (ROOT / "crdtbench").rglob("*")
        if p.is_file() and "__pycache__" not in p.parts)]
    return {p: p.read_bytes() for p in files}


def _throwaway_root(tmp_path):
    """A copy of BENCHMARK.json with one configuration and one cell
    appended, and the new cell's files, under ``tmp_path``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(
        {"name": CONFIG["name"], "source": "a test's throwaway",
         "file": "crdtbench/configs/rga4x64k.json", "reduced": [],
         "why": "a second catch-up configuration"})
    bench["workloads"].append(
        {"name": NEW, "config": CONFIG["name"], "traffic": "catchup",
         "chips": 1, "why": "the catchup driver under another config"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for sub, name, body in (("configs", "rga4x64k.json", CONFIG),
                            ("traffic", f"{NEW}.json", TRAFFIC),
                            ("tests/tiny", f"{NEW}.json", TINY_FILE)):
        d = tmp_path / "crdtbench" / sub
        d.mkdir(parents=True, exist_ok=True)
        (d / name).write_text(json.dumps(body))
    return tmp_path


def _line(capsys):
    out, _ = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1])


def test_a_cell_added_as_files_and_entries_runs(tmp_path, monkeypatch,
                                                capsys):
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
                "CUDA_CACHE_PATH"):
        monkeypatch.delenv(var, raising=False)      # restored afterwards
    before = _checkout()
    root = _throwaway_root(tmp_path)
    adjust = tiny_sizes(root / "crdtbench/tests/tiny" / f"{NEW}.json")
    spec = run.load_cell(root, NEW)
    assert spec["traffic"] == TRAFFIC
    for trace in (0, 1):
        rc = run.main(["--workload", NEW, "--seed", str(2**31 + 17),
                       "--seconds", "1.5", "--trace", str(trace)],
                      device="cpu", root=root, adjust=adjust)
        assert rc == 0
        line = _line(capsys)
        assert line["correct"] is True and line["attempted"] > 0
        listed_here = spec["per_layer"] if trace else spec["end_to_end"]
        assert set(line["metrics"]) == {m["name"] for m in listed_here}
    got = control.readings(NEW, 5, root=root, adjust=adjust)
    assert got["answers"] > 0 and got["order_mismatches"] > 0
    assert incomplete(root, NEW) == []
    (root / "crdtbench/tests/tiny" / f"{NEW}.json").unlink()
    assert incomplete(root, NEW) == [f"tiny size {NEW}"]
    assert _checkout() == before
