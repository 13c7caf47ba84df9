"""The port's durability headline entry points on the CPU path at a tiny
depth, with the reference's own test assertions that hold at that size
(``tests/test_wal.py``, ``test_oplog_cascade.py``, ``test_pipeline.py``
slow wrappers): ``bench_wal_headline``, ``bench_pipeline_headline``,
``bench_oplog_headline``, ``bench_coldpath_headline`` and
``bench_storfloor``.  Each output covers the keys of the reference
script's output: a run at the same size where that is cheap, else the
reference's committed output."""
from _torch_headline import assert_keys_cover, committed, ref_script

from crdt_graph_tpu_torch.scripts import (bench_coldpath_headline,
                                          bench_oplog_headline,
                                          bench_pipeline_headline,
                                          bench_storfloor,
                                          bench_wal_headline)


def test_wal_headline_legs(tmp_path):
    kw = dict(n_sessions=8, n_docs=2, writes_per_session=2, rounds=1)
    port = bench_wal_headline.run(out_path=str(tmp_path / "p.json"),
                                  device="cpu", **kw)
    ref = ref_script("bench_wal_headline").run(
        out_path=str(tmp_path / "r.json"), **kw)
    assert_keys_cover(port, ref, depth=3)
    best = port["best"]
    for mode in ("off", "batch", "commit"):
        assert best[mode]["violations"] == 0
        assert best[mode]["writes_acked"] == 16
        assert best[mode]["ack_p50_ms"] is not None
    assert best["off"]["wal"]["fsyncs"] == 0
    assert best["batch"]["wal"]["fsyncs"] >= 1
    for mode in ("batch", "commit"):
        w = best[mode]["wal"]
        assert w["fsyncs"] <= best[mode]["writes_acked"], (mode, w)
        assert w["appends"] == w["fsyncs"], (mode, w)
    assert port["host_platform"] == "cpu"


def test_pipeline_headline_legs(tmp_path):
    port = bench_pipeline_headline.run(
        out_path=str(tmp_path / "p.json"), n_sessions=8, n_docs=8,
        writes_per_session=2, delta_size=64, rounds=1, device="cpu")
    assert_keys_cover(port, committed("PIPELINE"))
    best = port["best"]
    for leg in ("pipelined", "serialized"):
        assert best[leg]["violations"] == 0
        assert best[leg]["writes_acked"] == 8 * 2
        assert best[leg]["wal"]["fsyncs"] >= 1, leg
    assert best["pipelined"]["pipeline"]["commits_synced"] > 0


def test_oplog_headline_restore(tmp_path):
    out = bench_oplog_headline.run(out_path=str(tmp_path / "p.json"),
                                   n_ops=24_000, hot_ops=2048,
                                   device="cpu")
    assert_keys_cover(out, committed("OPLOG"))
    assert out["fingerprints_equal"]
    assert out["n_ops"] == 24_000
    assert out["tiers"]["spills"] >= 1
    assert out["resident"]["ratio"] < 1.0
    assert out["windows"]["hot_p50_ms"] is not None


def test_coldpath_headline_legs(tmp_path):
    out = bench_coldpath_headline.run(
        out_path=str(tmp_path / "p.json"), n_ops=24_000,
        restore_rounds=1, fleet_docs=4, fleet_sessions=8,
        fleet_writes=2, fleet_rounds=1, device="cpu")
    assert_keys_cover(out, committed("COLDPATH"))
    assert out["fingerprints_equal"]
    best = out["restore"]["best"]
    assert best["matz"]["matz_stats"]["loads"] == 1
    assert best["matz"]["matz_stats"]["fallbacks"] == 0
    assert best["matz"]["n_visible"] == best["nomatz"]["n_visible"] \
        == 24_000
    fl = out["fleet"]
    assert fl["best"]["shared"]["violations"] == 0
    assert fl["best"]["perdoc"]["violations"] == 0
    assert fl["best"]["shared"]["fsyncs_per_round"] <= \
        fl["best"]["perdoc"]["fsyncs_per_round"]


def test_storfloor_legs(tmp_path):
    out = bench_storfloor.run(out_path=str(tmp_path / "p.json"),
                              n_sessions=8, n_docs=4,
                              writes_per_session=2, rounds=1,
                              device="cpu")
    assert_keys_cover(out, committed("STORFLOOR"))
    for backend in ("single", "auto"):
        assert out["sync_backend_ab"]["best"][backend]["violations"] == 0
    shm = out["shm_fleet"]
    assert (shm["misses"], shm["hits"]) == (4, 8)
    sf = out["sendfile"]
    assert sf["byte_identical"] and sf["windows_zero_copy"] >= 1
    assert sf["windows_compared"] >= 1


def test_default_output_under_build():
    """Without ``out_path`` an output goes to ``build/headline`` under
    the checkout, never over a committed reference file."""
    from crdt_graph_tpu_torch.scripts import _headline
    for name in ("wal", "pipeline", "oplog", "coldpath", "storfloor"):
        path = _headline.out_path(name)
        assert path == str(_headline.ROOT / "build" / "headline"
                           / f"BENCH_{name.upper()}.json")
