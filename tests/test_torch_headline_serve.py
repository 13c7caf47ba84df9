"""The port's serving headline entry points on the CPU path, held to the
reference scripts: ``serve_smoke`` (every leg, with the reference's own
test assertions, and its fleet counts and shm ledger equal to the
reference script's), ``bench_serve_headline``, ``bench_fleet_headline``
and ``bench_visibility_headline`` at a tiny depth, each output covering
the keys of the reference script's output at the same size."""
import json

import pytest

from _torch_headline import assert_keys_cover, ref_script

from crdt_graph_tpu_torch.scripts import (bench_fleet_headline,
                                          bench_serve_headline,
                                          bench_visibility_headline,
                                          serve_smoke)


@pytest.fixture(scope="module")
def ref_smoke():
    return ref_script("serve_smoke")


def test_serve_smoke_end_to_end():
    """The reference's ``test_serve_smoke_end_to_end`` on the port."""
    summary = serve_smoke.run(n_docs=4, writers_per_doc=3, deltas=3,
                              delta_size=8, device="cpu")
    assert len([k for k in summary if k.startswith("smoke")]) == 4
    assert summary["scheduler"]["queue_depth_total"] == 0
    assert summary["flight"]["records_total"] >= 1
    assert summary["flight"]["trace_ids_seen"] >= 36   # 4×3×3 pushes
    assert summary["connpool"]["reuses"] > summary["connpool"]["opens"]
    assert summary["transport_retries"] == 0
    assert all(summary[f"smoke{i}"]["visible"] == 3 * 3 * 8
               for i in range(4))
    assert summary["watch"]["readcache_misses_delta"] == 2
    assert summary["device"] == {"name": "cpu", "power_limit": None}
    assert summary["flight_audit"] == {"sampled": 0, "failures": 0}


def test_fleet_smoke_equals_reference(ref_smoke):
    """The fleet leg: the reference test's counts, and the same writes,
    read-backs, visible values and state fingerprints as the reference
    script's fleet on the same workload."""
    port = serve_smoke.run_fleet(n_servers=3, n_docs=2, device="cpu")
    ref = ref_smoke.run_fleet(n_servers=3, n_docs=2)
    assert port["writes"] == ref["writes"] == 6
    assert port["cross_server_ryw"] == ref["cross_server_ryw"] == 6
    assert port["forwarded"] > 0
    for doc in ("fleet0", "fleet1"):
        assert port[doc]["visible"] == ref[doc]["visible"] == 15
        assert port[doc]["state_fingerprint"] == \
            ref[doc]["state_fingerprint"]
    assert_keys_cover(port, ref)


def test_fleet_procs_shm_exact_ledger():
    """Three port server processes on one host-shared body cache: the
    reference's exact ledger (misses 4, hits 8, no leak)."""
    summary = serve_smoke.run_fleet_procs(n_procs=3, gens=4, device="cpu")
    assert summary["misses"] == 4
    assert summary["hits"] == 8
    assert summary["shared_bytes"] > 0


def test_mergetier_smoke_end_to_end():
    summary = serve_smoke.run_mergetier(n_docs=3, n_ops=1200, device="cpu")
    assert summary["remote_docs"] == 3
    assert summary["batch_width_max"] == 3
    assert summary["launches"] == 1
    assert summary["fallbacks"] == {}


def test_serve_smoke_cli_runs_on_cpu(capsys):
    assert serve_smoke.main(["2", "2", "2", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["smoke0"]["visible"] == 2 * 2 * 12


SERVE_TINY = dict(n_sessions=4, writes_per_session=1, n_docs=2,
                  giant_ops=0)


def test_serve_headline_keys_and_oracle(tmp_path):
    port = bench_serve_headline.run(out_path=str(tmp_path / "p.json"),
                                    device="cpu", **SERVE_TINY)
    ref = ref_script("bench_serve_headline").run(
        out_path=str(tmp_path / "r.json"), **SERVE_TINY)
    assert_keys_cover(port, ref)
    assert port["violations_total"] == 0
    assert not port["report"]["errors"]
    assert port["ops_merged"] == port["total_leaves"] == 4 * 12
    assert port["report"]["oracle"]["max_coalesce_width"] >= 2
    assert port["host"] == "cpu"
    with open(tmp_path / "p.json") as f:
        assert json.load(f)["sessions"] == 4


FLEET_TINY = dict(n_sessions=6, writes_per_session=1, n_docs=2,
                  giant_ops=1500)


def test_fleet_headline_keys_kill_and_convergence(tmp_path):
    port = bench_fleet_headline.run(out_path=str(tmp_path / "p.json"),
                                    device="cpu", **FLEET_TINY)
    ref = ref_script("bench_fleet_headline").run(
        out_path=str(tmp_path / "r.json"), **FLEET_TINY)
    assert_keys_cover(port, ref)
    rep = port["report"]
    assert port["violations_total"] == 0
    assert not rep["errors"], rep["errors"]
    assert port["servers"] == 3 and port["sessions"] == 6
    assert rep["kill"] and "failover_s" in rep["kill"]
    assert rep["kill"]["rejoined_epoch"] >= 2
    assert port["converged_docs"] == 2
    assert port["read_replica_p99_ms"] is not None


def test_visibility_headline_keys_and_ledger(tmp_path):
    kw = dict(n_sessions=6, writes_per_session=2, n_docs=2,
              giant_ops=1500)
    port = bench_visibility_headline.run(
        out_path=str(tmp_path / "p.json"), device="cpu", **kw)
    ref = ref_script("bench_visibility_headline").run(
        out_path=str(tmp_path / "r.json"), **kw)
    assert_keys_cover(port, ref)
    gate = port["gate"]
    assert gate["zero_violations"] and gate["stage_lag_present"]
    assert port["violations_total"] == 0
    for stage in ("publish", "replica"):
        lag = port["visibility_lag_s"][stage]
        assert lag["count"] > 0 and lag["p99"] is not None
    assert port["canary"]["failures"] == 0
