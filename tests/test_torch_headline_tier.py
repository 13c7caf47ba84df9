"""The port's merge-tier and fan-out headline entry points on the CPU
path at a tiny depth: ``bench_mergetier_headline`` (the reference test's
assertions that hold at that size: no violation, no error, no fallback
on either tiered leg, a remote merge on each) and
``bench_fanout_headline`` (one cached encode for a parked population,
byte-identical deliveries, both legs' replicas equal to the served
document).  A speed gate the reference sets for its hardware may fail
at this size: the run then raises after writing its output, which the
test reads."""
from _torch_headline import assert_keys_cover, committed, run_gated

from crdt_graph_tpu_torch.scripts import (bench_fanout_headline,
                                          bench_mergetier_headline)


def test_mergetier_headline_legs(tmp_path, monkeypatch):
    monkeypatch.setattr(bench_mergetier_headline, "WRITES_PER_SESSION", 1)
    # two sessions a document: the staged first round releases at once
    monkeypatch.setattr(bench_mergetier_headline, "SESSIONS_PER_DOC", 2)
    path = str(tmp_path / "p.json")
    out = run_gated(lambda: bench_mergetier_headline.run(
        rounds=1, out_path=path, device="cpu"), path)
    assert_keys_cover(out, committed("MERGETIER"))
    assert out["violations_total"] == 0 and out["errors_total"] == 0
    legs = out["legs"]
    for leg in ("coalesced", "perreplica"):
        best = legs[leg]["best"]
        assert not best["fallbacks"], (leg, best["fallbacks"])
        assert best["remote_docs"] >= 1
        assert best["worker_launches"] >= 1
    assert legs["local"]["best"]["writes_per_sec"] > 0
    assert legs["coalesced"]["best"]["writes_acked"] == \
        3 * 2 * bench_mergetier_headline.N_DOCS
    assert out["gate"]["pass"] == (out["mean_width_ratio"] >= 2.0)


def test_fanout_headline_population_and_legs(tmp_path, monkeypatch):
    monkeypatch.setattr(bench_fanout_headline, "WATCHERS", 60)
    monkeypatch.setattr(bench_fanout_headline, "AB_CLIENTS", 4)
    monkeypatch.setattr(bench_fanout_headline, "AB_WALL_S", 1.0)
    path = str(tmp_path / "p.json")
    out = run_gated(lambda: bench_fanout_headline.run(
        rounds=1, out_path=path, device="cpu"), path)
    assert_keys_cover(out, committed("FANOUT"))
    fan = out["fanout"]
    assert fan["watchers"] == 60
    assert fan["unique_bodies"] == 1 and fan["events"] == {"notify": 60}
    assert fan["one_encode"]
    assert fan["readcache_misses_delta"] == 1
    assert fan["readcache_hits_delta"] == 59
    assert fan["registered_after"] == 0
    assert out["violations_total"] == 0 and out["errors_total"] == 0
    for leg in ("watch", "poll"):
        assert out["legs"][leg]["best"]["reads_delivered"] >= 1
