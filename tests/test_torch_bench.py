"""The port's benches, held to the reference's.

- **Rows**: ``bench.runner.run`` over configs 1-8 (1-2 at their full
  size, 3-8 from the same generators with small arguments, patched into
  both packages' ``CONFIGS`` and closed forms), under ``hints=None`` and
  ``"exhaustive"``, gives rows that agree with the reference's on
  ``n_ops``, ``num_nodes``, ``num_visible``, ``fingerprint_v`` and
  ``order_check`` (exact), and carry a passing timing audit.
- **Replay**: each test of the reference's ``tests/test_bench_workloads.py``
  (``test_runner_smoke`` included) and ``tests/test_incremental.py``
  runs again with its names pointed at the port, on the CPU.  The
  per-op latency test keeps the reference's own margin.
"""
import functools
import types

import pytest

import test_bench_workloads as ref_workloads  # noqa: E402 — JAX on CPU
import test_incremental as ref_incremental  # noqa: E402
import _torch_replay  # noqa: E402

from crdt_graph_tpu.bench import runner as jrunner  # noqa: E402
from crdt_graph_tpu.bench import workloads as jworkloads  # noqa: E402

from crdt_graph_tpu_torch.bench import incremental as tincremental  # noqa: E402
from crdt_graph_tpu_torch.bench import runner as trunner  # noqa: E402
from crdt_graph_tpu_torch.bench import workloads as tworkloads  # noqa: E402
from crdt_graph_tpu_torch.codec import packed as tpacked  # noqa: E402
from crdt_graph_tpu_torch.core import operation as top  # noqa: E402
from crdt_graph_tpu_torch.core import tree as ttree  # noqa: E402
from crdt_graph_tpu_torch.models import text as ttext  # noqa: E402
from crdt_graph_tpu_torch.ops import merge as tmerge  # noqa: E402
from crdt_graph_tpu_torch.ops import view as tview  # noqa: E402

# (name, generator, closed form) of each config at the test size; the
# same calls on each package's own ``workloads``
SMALL = {
    1: ("flat_editor_replay_1k", lambda w: w.editor_replay(1000), None),
    2: ("two_replica_interleaved_10k",
        lambda w: w.two_replica_interleaved(10_000), None),
    3: ("nested_depth8_8rep_2k", lambda w: w.nested_tree(2000), None),
    4: ("tombstone_heavy_1k", lambda w: w.tombstone_heavy(1000), None),
    5: ("join_64rep_4k", lambda w: w.chain_workload(64, 4096),
        lambda w: w.chain_expected_ts(64, 4096)),
    6: ("adv_descending_chains_16rep_512",
        lambda w: w.descending_chains(16, 512),
        lambda w: w.descending_expected_ts(16, 512)),
    7: ("adv_comb_512", lambda w: w.comb_pairs(512),
        lambda w: w.comb_expected_ts(512)),
    8: ("adv_deep_paths_4_403", lambda w: w.deep_paths(4, 403),
        lambda w: w.deep_expected_ts(4, 403)),
}
SAME = ("n_ops", "num_nodes", "num_visible", "fingerprint_v",
        "order_check", "name", "hints")


@pytest.mark.parametrize("hints", [None, "exhaustive"])
@pytest.mark.parametrize("cid", sorted(SMALL))
def test_runner_row_equals_reference(cid, hints, monkeypatch):
    name, gen, closed = SMALL[cid]
    for wmod, rmod in ((jworkloads, jrunner), (tworkloads, trunner)):
        monkeypatch.setitem(wmod.CONFIGS, cid,
                            (name, functools.partial(gen, wmod)))
        if closed is not None:
            monkeypatch.setitem(rmod._CLOSED_FORMS, cid,
                                functools.partial(closed, wmod))
    (want,) = jrunner.run([cid], repeats=1, hints=hints)
    (got,) = trunner.run([cid], repeats=1, hints=hints, device="cpu")
    assert {k: got[k] for k in SAME} == {k: want[k] for k in SAME}
    assert got["order_check"] == "exact"
    assert got["audit"]["ok"], got["audit"]
    assert got["p50_ms"] > 0 and got["ops_per_sec"] > 0
    assert got["dispatch_overhead_ms"] > 0
    # the trace audit's keys: the reference's record shapes, the
    # reference's crowding leg, and no error
    ca = got["chain_audit"]
    assert "error" not in ca, ca
    assert {"fast_path", "static", "budget", "ok"} <= set(ca)
    assert ca["crowding_leg"] == want["opsaxis"]["leg"]
    assert ca["merges"] == 1 and ca["device_ops"] > 0
    assert set(got["opsaxis"]) == set(want["opsaxis"]), got["opsaxis"]
    assert got["opsaxis"]["leg"] == want["opsaxis"]["leg"]
    assert got["opsaxis"]["ok"], got["opsaxis"]


CRDT = types.SimpleNamespace(
    init=ttree.init, Add=top.Add, Delete=top.Delete, TAKE=ttree.TAKE)
MERGE = types.SimpleNamespace(
    materialize=functools.partial(tmerge.materialize, device="cpu"))
RUNNER = types.SimpleNamespace(
    run=functools.partial(trunner.run, device="cpu"))


@pytest.mark.parametrize("name,index",
                         _torch_replay.cases(ref_workloads, set()))
def test_bench_workloads_test_passes_on_port(name, index, tmp_path,
                                             monkeypatch):
    _torch_replay.run(ref_workloads, name, index, tmp_path, monkeypatch,
                      names=(("crdt", CRDT), ("workloads", tworkloads),
                             ("packed", tpacked), ("op_mod", top),
                             ("merge", MERGE), ("view", tview)),
                      modules=(("crdt_graph_tpu.bench.runner", RUNNER),))


TEXT = types.SimpleNamespace(TextBuffer=functools.partial(
    ttext.TextBuffer, device="cpu"))
INCREMENTAL = types.SimpleNamespace(
    run=functools.partial(tincremental.run, device="cpu"),
    seed_document=tincremental.seed_document,
    editor_replay=tincremental.editor_replay)


@pytest.mark.parametrize("name,index",
                         _torch_replay.cases(ref_incremental, set()))
def test_incremental_test_passes_on_port(name, index, tmp_path,
                                         monkeypatch):
    _torch_replay.run(ref_incremental, name, index, tmp_path, monkeypatch,
                      names=(("incremental", INCREMENTAL),),
                      modules=(("crdt_graph_tpu.models.text", TEXT),))
