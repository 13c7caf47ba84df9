"""The port's host-path headline entry points on the CPU path, held to
the reference scripts on the same inputs: ``bench_opsaxis_headline``
(the sharded and single merges' fingerprint equal to the reference
script's), ``bench_egress`` and ``bench_service_e2e`` (the same bytes on
every path and leg), ``bench_slo`` (every acked op in the served
document), ``soak`` (every session's converged values equal to the
reference soak's), and the two baselines' entry points,
``bench_readpath`` and ``bench_broadcast_headline``, whose two legs
serve byte-identical wire."""
import json

import pytest
from _torch_headline import (assert_keys_cover, committed, ref_script,
                             run_gated)

from crdt_graph_tpu_torch.scripts import (_headline,
                                          bench_broadcast_headline,
                                          bench_egress, bench_opsaxis_headline,
                                          bench_readpath, bench_service_e2e,
                                          bench_slo, soak)


def test_opsaxis_fingerprint_equals_reference(tmp_path):
    port = bench_opsaxis_headline.run(8192, 1, str(tmp_path / "p.json"),
                                      device="cpu")
    ref = ref_script("bench_opsaxis_headline").run(
        8192, 1, str(tmp_path / "r.json"))
    assert port["devices"] == ref["devices"] == 8
    assert port["n_ops"] == ref["n_ops"]
    assert port["fingerprint"] == ref["fingerprint"]
    assert port["bit_identical"]
    audit = port["opsaxis_audit"]
    assert audit["ok"] and audit["collective_count"] >= 1
    assert audit["shard_width"] <= audit["shard_budget"]
    assert port["tripwire"]["ok"]
    assert_keys_cover(port, ref, depth=1)


def _printed(capsys):
    return [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]


def test_egress_bytes_equal_reference(capsys, tmp_path):
    port = bench_egress.run(6400, str(tmp_path / "p.json"), device="cpu")
    ref_script("bench_egress").main(6400)
    ref = _printed(capsys)
    assert [r["path"] for r in port["rows"]] == [r["path"] for r in ref]
    for p, r in zip(port["rows"], ref):
        assert set(r) <= set(p)
        assert p["bytes"] == r["bytes"], r["path"]
    assert port["rows"][1]["byte_identical"]


def test_service_e2e_bytes_equal_reference(capsys, tmp_path):
    port = bench_service_e2e.run(4096, str(tmp_path / "p.json"),
                                 device="cpu")
    ref_script("bench_service_e2e").main(4096)
    ref = _printed(capsys)
    assert port["wire_identical"]
    assert [g["leg"] for g in port["legs"]] == [g["leg"] for g in ref]
    for p, r in zip(port["legs"], ref):
        assert set(r) <= set(p)
        assert p["bytes"] == r["bytes"], r["leg"]


def test_slo_rows_and_read_back(tmp_path):
    out = bench_slo.run(1024, 4, str(tmp_path / "p.json"), device="cpu")
    assert [r["delta_ops"] for r in out["rows"]] == [1, 64, 4096]
    want = {"delta_ops", "requests", "p50_ms", "p99_ms", "max_ms",
            "route", "bootstrap_ops"}
    for r in out["rows"]:
        assert want <= set(r)
        assert r["p50_ms"] <= r["p99_ms"] <= r["max_ms"]
    assert out["rows"][2]["requests"] == 10
    assert out["rows"][2]["visible"] == 1024 + 13 * 4096


def test_soak_values_equal_reference(tmp_path):
    out = soak.run(4, str(tmp_path / "p.json"), device="cpu")
    ref = ref_script("soak")
    for k in range(4):
        merged, ops, _ = ref.random_session(1000 + k)
        values = merged.visible_values()
        assert out["visible"][k] == len(values)
        assert out["values_digests"][k] == soak.values_digest(values)
    assert out["sessions"] == 4 and out["ops"] > 0


def test_readpath_legs_and_wire_identity(tmp_path, monkeypatch):
    monkeypatch.setattr(bench_readpath, "PRELOAD_OPS", 4096)
    monkeypatch.setattr(bench_readpath, "N_SESSIONS", 2)
    monkeypatch.setattr(bench_readpath, "WRITES_PER_SESSION", 2)
    monkeypatch.setattr(bench_readpath, "READS_PER_WRITE", 3)
    path = str(tmp_path / "p.json")
    out = run_gated(lambda: bench_readpath.run(1, path, device="cpu"),
                    path)
    assert_keys_cover(out, committed("READPATH"))
    wi = out["wire_identity"]
    assert wi["doc_body_identical"] and wi["window_body_identical"]
    assert wi["etag_identical"] and wi["since_headers_identical"]
    cp = out["conditional_poll"]
    assert cp["not_modified"] == cp["polls"] and cp["write_invalidates"]
    assert out["violations_total"] == 0
    cached = out["legs"]["cached"]["best"]["readcache"]
    seed = out["legs"]["seed"]["best"]["readcache"]
    assert cached["enabled"] and not seed["enabled"]
    assert seed["hits"] == 0 and cached["hits"] > 0


@pytest.mark.parametrize("passed", [True, False])
def test_speed_gate_raises_only_on_a_failed_gate(passed):
    out = {"gate": {"want": "ratio >= 2x", "pass": passed}}
    if passed:
        assert _headline.speed_gate(out, 2.5) is None
        return
    with pytest.raises(_headline.SpeedGateFailed) as e:
        _headline.speed_gate(out, 1.5)
    assert isinstance(e.value, AssertionError)
    assert e.value.args == ("ratio >= 2x", 1.5)


def test_readpath_correctness_failure_is_not_a_speed_gate(tmp_path,
                                                          monkeypatch):
    """A broken conditional GET raises a plain ``AssertionError`` after
    the output is written, which ``run_gated`` (as ``chip_smoke.py``'s
    headline phase) does not take for a missed speed gate."""
    monkeypatch.setattr(bench_readpath, "PRELOAD_OPS", 4096)
    monkeypatch.setattr(bench_readpath, "N_SESSIONS", 2)
    monkeypatch.setattr(bench_readpath, "WRITES_PER_SESSION", 1)
    monkeypatch.setattr(bench_readpath, "READS_PER_WRITE", 2)
    broken = {"polls": 3, "not_modified": 2, "write_invalidates": True}
    monkeypatch.setattr(bench_readpath, "_conditional_poll",
                        lambda dev: dict(broken))
    path = str(tmp_path / "p.json")
    with pytest.raises(AssertionError) as e:
        run_gated(lambda: bench_readpath.run(1, path, device="cpu"), path)
    assert not isinstance(e.value, _headline.SpeedGateFailed)
    with open(path) as f:
        assert json.load(f)["conditional_poll"] == broken


def test_broadcast_legs_and_wire_identity(tmp_path, monkeypatch):
    for name, value in (("THREADED_WATCHERS", 24), ("AB_WATCHERS", 24),
                        ("BIG_WATCHERS", 80), ("ROUNDS", 2),
                        ("REPEATS", 1), ("CHILDREN", 2)):
        monkeypatch.setattr(bench_broadcast_headline, name, value)
    path = str(tmp_path / "p.json")
    out = run_gated(lambda: bench_broadcast_headline.run(path,
                                                         device="cpu"),
                    path)
    assert_keys_cover(out, committed("BROADCAST"))
    assert out["wire_identity"]["identical"]
    assert out["wire_identity"]["events"] == {
        "resume": "resume", "notify": "notify", "timeout": "timeout"}
    assert out["violations_total"] == 0 and out["errors_total"] == 0
    threaded = out["ab"]["threaded"]["best"]
    reactor = out["ab"]["reactor"]["best"]
    # a parked watcher holds a handler thread only on the threaded leg
    assert threaded["threads_parked_delta"] >= 24
    assert threaded["reactor"] is None
    assert reactor["reactor"]["threads"] <= 4
    assert out["capacity"]["deliveries"] == 80 * 2
