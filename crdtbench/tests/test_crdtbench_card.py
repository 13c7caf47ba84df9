"""On the card: one short run of each cell comes out correct, with the
contract's device record.  Skips without a CUDA device."""
import json
import subprocess
import sys

import pytest

from crdtbench import run
from crdtbench.tests.conftest import listed


@pytest.mark.cuda
@pytest.mark.parametrize("workload", listed())
def test_short_run_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "-m", "crdtbench", "--workload", workload,
         "--seed", str(2**31 + 3), "--seconds", "30", "--trace", "0"],
        cwd=str(run.HERE.parent), capture_output=True, text=True,
        timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0
