"""The comparison fails what it must: the control (the reference with
concurrent siblings in arrival order) at a small size, and whole runs
with the timed path broken underneath by each fault of the cell's
driver (``faults/<driver>.py``)."""
import json

import pytest

from crdtbench import control, run
from crdtbench.tests.conftest import (ROOT, TINY, driver_of, faults_of,
                                      listed)


@pytest.mark.parametrize("seed", (1, 2, 3))
@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_is_not_correct(workload, seed, root):
    got = control.readings(workload, seed, root=root, adjust=TINY[workload])
    assert got["answers"] > 0
    assert got["order_mismatches"] > 0


BROKEN = [(w, f) for w in listed()
          for f in sorted(faults_of(driver_of(ROOT, w)))]


@pytest.mark.parametrize("workload,fault", BROKEN)
def test_broken_timed_path_is_not_correct(workload, fault, root,
                                          monkeypatch, capsys):
    faults_of(driver_of(root, workload))[fault](monkeypatch)
    rc = run.main(["--workload", workload, "--seed", "12345",
                   "--seconds", "1", "--trace", "0"],
                  device="cpu", root=root, adjust=TINY[workload])
    out, _ = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
