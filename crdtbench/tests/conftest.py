"""Tests of the benchmark itself.  CPU tests run the program's plain
twins at tiny sizes (``device="cpu"``); tests marked ``cuda`` need the
card and skip elsewhere (decided inside a fixture).

The cells come from ``BENCHMARK.json``.  A cell's tiny size is
``tiny/<workload>.json`` (``{"config": {...}, "traffic": {...}}``, keys
applied over the cell's own files), and its driver's timed-path faults
are ``faults/<driver>.py`` (``FAULTS``: fault name → a function of
``monkeypatch`` that breaks the timed path underneath)."""
import importlib.util
import json
from pathlib import Path

import pytest

from crdtbench import drivers, run

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent

# the faults every driver's file has: a step that returns its state
# unchanged, part of the input left out, an answer altered where it is
# produced
FAULT_KINDS = ("unchanged", "half", "altered")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips elsewhere")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def root():
    """The checkout's root, whose BENCHMARK.json lists the cells."""
    return ROOT


def tiny_sizes(path: Path):
    """``adjust(config, traffic)`` that applies a tiny file's keys over a
    cell's own configuration and traffic."""
    sizes = json.loads(Path(path).read_text())

    def adjust(config, traffic):
        config.update(sizes.get("config", {}))
        traffic.update(sizes.get("traffic", {}))
    return adjust


TINY = {p.name.removesuffix(".json"): tiny_sizes(p)
        for p in sorted((HERE / "tiny").glob("*.json"))}


def listed(root: Path = ROOT) -> list:
    """The names of the cells ``BENCHMARK.json`` under ``root`` lists."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


def traffic_file(root: Path, workload: str) -> Path:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    return (root / "crdtbench" / "traffic"
            / f"{cell['config']}.{cell['traffic']}.json")


def driver_of(root: Path, workload: str):
    """The driver the cell's traffic names; None without a traffic file."""
    path = traffic_file(root, workload)
    return json.loads(path.read_text())["driver"] if path.exists() else None


def faults_of(driver) -> dict:
    """The driver's ``FAULTS``; empty without a faults file."""
    path = HERE / "faults" / f"{driver}.py"
    if not path.exists():
        return {}
    spec = importlib.util.spec_from_file_location(
        f"crdtbench.tests.faults.{driver}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FAULTS


def incomplete(root: Path, workload: str) -> list:
    """What the cell lacks of the files a run and its tests read: its
    configuration, traffic and tiny files under ``root``; its driver, a
    reader of each metric it lists and its driver's faults in the
    harness."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    entry = next((c for c in bench["configs"]
                  if c["name"] == cell["config"]), None)
    lacks = []
    if entry is None or not (root / entry["file"]).exists():
        lacks.append(f"configuration {cell['config']}")
    if not traffic_file(root, workload).exists():
        lacks.append(f"traffic {traffic_file(root, workload).name}")
    driver = driver_of(root, workload)
    try:
        drv = drivers.load(driver) if driver else None
    except ImportError:
        drv = None
    if not all(callable(getattr(drv, m, None)) for m in drivers.INTERFACE):
        lacks.append(f"driver {driver}")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if ("workloads" not in m or workload in m["workloads"]) \
                and not (run.HERE / "metrics" / f"{m['name']}.py").exists():
            lacks.append(f"reader {m['name']}")
    if not (root / "crdtbench/tests/tiny" / f"{workload}.json").exists():
        lacks.append(f"tiny size {workload}")
    if not set(FAULT_KINDS) <= set(faults_of(driver)):
        lacks.append(f"faults of {driver}")
    return lacks
