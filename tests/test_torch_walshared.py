"""The port's shared group-commit WAL stream (``GRAFT_WAL_SHARED``),
held to the reference's own tests and to the reference across packages.

The reference's shared-stream tests of ``tests/test_wal.py`` (one fsync
covers a whole round, a failed sync after a repair drops the unsynced
tail, a full disk sheds every covered commit, the mode flip refuses with
a typed ``WalError``), the shared cases of its crash-point matrix that
its tier-1 run keeps, and the once-per-cadence stream scrub of
``tests/test_readpath.py`` run again with those modules' names pointed
at the port (``ServingEngine(device="cpu")``, ``wal``, the codec, the
engine, ``obs``).  Across packages: a shared-stream engine killed at a
crash site in one package is recovered by the other, every document
equal in values and ``state_fingerprint``; and a shared engine renders
the reference's metric families.
"""
import functools
import shutil
import threading

import pytest

import test_readpath as ref_readpath  # noqa: E402 — JAX on the CPU
import test_wal as ref_wal  # noqa: E402
import _torch_replay  # noqa: E402

from crdt_graph_tpu.codec import json_codec as jjson  # noqa: E402
from crdt_graph_tpu.core.operation import Add as JAdd  # noqa: E402
from crdt_graph_tpu.core.operation import Batch as JBatch  # noqa: E402
from crdt_graph_tpu.obs import flight as jflight  # noqa: E402
from crdt_graph_tpu.obs import prom as jprom  # noqa: E402
from crdt_graph_tpu.serve import SchedulerStopped as JStopped  # noqa: E402
from crdt_graph_tpu.serve import ServingEngine as JEngine  # noqa: E402

from crdt_graph_tpu_torch import engine as tengine  # noqa: E402
from crdt_graph_tpu_torch import wal as twal  # noqa: E402
from crdt_graph_tpu_torch.codec import json_codec as tjson  # noqa: E402
from crdt_graph_tpu_torch.codec import packed as tpacked  # noqa: E402
from crdt_graph_tpu_torch.core.operation import (  # noqa: E402
    Add, Batch, Delete)
from crdt_graph_tpu_torch.obs import flight as tflight  # noqa: E402
from crdt_graph_tpu_torch.obs import oracle as toracle  # noqa: E402
from crdt_graph_tpu_torch.obs import prom as tprom  # noqa: E402
from crdt_graph_tpu_torch.serve import (  # noqa: E402
    SchedulerStopped, ServingEngine, WalUnavailable)

OFF = 2**32
JOIN_S = 30.0
PORT_ENGINE = functools.partial(ServingEngine, device="cpu")

WAL_NAMES = (
    ("ServingEngine", PORT_ENGINE), ("SchedulerStopped", SchedulerStopped),
    ("WalUnavailable", WalUnavailable), ("wal_mod", twal),
    ("json_codec", tjson), ("packed_mod", tpacked), ("engine", tengine),
    ("Add", Add), ("Batch", Batch), ("Delete", Delete),
    ("flight_mod", tflight), ("oracle_mod", toracle), ("prom_mod", tprom))

SHARED_TESTS = ("test_shared_wal_one_fsync_covers_whole_round",
                "test_shared_wal_failed_sync_after_repair_reopen_drops_tail",
                "test_shared_wal_disk_full_sheds_all_covered_commits",
                "test_wal_mode_flip_across_restart_refuses_loudly")


@pytest.fixture(autouse=True)
def _no_crash_site(monkeypatch):
    monkeypatch.delenv("GRAFT_CRASH_POINT", raising=False)
    monkeypatch.delenv("GRAFT_CRASH_EXIT", raising=False)
    monkeypatch.delenv("GRAFT_WAL_SHARED", raising=False)


@pytest.mark.parametrize("name", SHARED_TESTS)
def test_shared_wal_test_passes_on_port(name, tmp_path, monkeypatch):
    _torch_replay.run(ref_wal, name, None, tmp_path, monkeypatch,
                      names=WAL_NAMES)


def _shared_matrix_cases():
    """The crash-point matrix cases on the shared stream that the
    reference's tier-1 run keeps (its slow-marked duplicates stay out)."""
    out = []
    for p in _torch_replay.cases(ref_wal, set()):
        name, index = p.values
        if name == "test_crash_point_matrix_zero_acked_loss" and \
                _torch_replay.case_values(ref_wal, name, index)["shared"]:
            out.append(p)
    return out


@pytest.mark.parametrize("name,index", _shared_matrix_cases())
def test_shared_crash_matrix_case_passes_on_port(name, index, tmp_path,
                                                 monkeypatch):
    """Each kill site on the shared stream, serialized and pipelined as
    the reference keeps them: no acked write lost, the recovered
    document serves at epoch 2 with windows byte-identical to the
    untiered contract, and the oracle reports no violation."""
    _torch_replay.run(ref_wal, name, index, tmp_path, monkeypatch,
                      names=WAL_NAMES)


def test_shared_stream_scrub_passes_on_port(tmp_path, monkeypatch):
    """The reference's once-per-cadence sweep of the one shared stream
    (``tests/test_readpath.py``) on the port's engine."""
    _torch_replay.run(
        ref_readpath, "test_shared_wal_scrub_sweeps_stream_once_per_cadence",
        None, tmp_path, monkeypatch, names=(
            ("ServingEngine", PORT_ENGINE), ("json_codec", tjson),
            ("Add", Add), ("Batch", Batch)))


# -- across packages --------------------------------------------------------

PKG = {"ref": (JEngine, jflight, JStopped, jjson, JAdd, JBatch),
       "port": (ServingEngine, tflight, SchedulerStopped, tjson, Add,
                Batch)}
DOCS = ("d0", "d1", "d2", "d3")


def _engine(pkg, ddir, **kw):
    cls, flight = PKG[pkg][:2]
    kw.setdefault("oplog_hot_ops", 8)
    kw.setdefault("submit_timeout_s", 2.0)
    if pkg == "port":
        kw["device"] = "cpu"
    return cls(durable_dir=str(ddir), flight=flight.FlightRecorder(),
               wal_sync="batch", wal_shared=True, **kw)


def _body(pkg, rid, n, start=1):
    _, _, _, codec, add, batch = PKG[pkg]
    prev = rid * OFF + start - 1 if start > 1 else 0
    ops = []
    for c in range(start, start + n):
        ops.append(add(rid * OFF + c, (prev,), f"v{rid}.{c}"))
        prev = rid * OFF + c
    return codec.dumps(batch(tuple(ops)))


def _state(pkg, ddir):
    """``{doc: (values, state_fingerprint)}`` of every document a fresh
    shared-stream engine of ``pkg`` recovers from ``ddir``."""
    eng = _engine(pkg, ddir)
    try:
        out = {}
        for d in DOCS:
            doc = eng.get(d, create=False)
            assert doc is not None and doc.recovered
            snap = doc.read_view()
            out[d] = (tuple(snap.values), snap.state_fingerprint())
        return out
    finally:
        eng.close()


def _killed(pkg, ddir, site, monkeypatch):
    """Acked writes to every document on one shared stream, then one
    more write killed at ``site`` (in process: the thread that reaches
    the site dies as under SIGKILL).  Returns each document's acked
    values."""
    eng = _engine(pkg, ddir)
    acked = {d: [] for d in DOCS}
    for k, d in enumerate(DOCS):
        for start in (1, 6, 11):
            assert eng.submit(d, _body(pkg, k + 1, 5, start))[0]
            acked[d] += [f"v{k + 1}.{c}" for c in range(start, start + 5)]
    assert eng.flush(JOIN_S)
    monkeypatch.setenv("GRAFT_CRASH_POINT", site)
    box = {}

    def doomed():
        try:
            box["ack"] = eng.submit("d0", _body(pkg, 1, 20, 16))
        except PKG[pkg][2] as e:
            box["err"] = e

    th = threading.Thread(target=doomed, daemon=True)
    th.start()
    eng.scheduler.join(JOIN_S)
    assert not eng.scheduler.is_alive(), f"{pkg}/{site}: never fired"
    th.join(JOIN_S)
    assert not th.is_alive() and "ack" not in box
    # a kill takes every thread: stop the maintenance lane so no task
    # of the dead engine writes under the recovery
    if eng.maintenance is not None:
        eng.maintenance.stop(timeout=JOIN_S)
    monkeypatch.delenv("GRAFT_CRASH_POINT")
    return acked


@pytest.mark.parametrize("site", ["ack-pre-fsync", "post-fsync-pre-publish"])
def test_killed_shared_stream_recovers_across_packages(tmp_path, site,
                                                       monkeypatch):
    """A reference engine on the shared stream killed at ``site`` is
    recovered by the port, and a port engine by the reference: every
    acked write reads back, and every document's values and
    ``state_fingerprint`` equal the writing package's own recovery of
    the same directory, and the other package's run of the same
    workload."""
    acked = {pkg: _killed(pkg, tmp_path / pkg, site, monkeypatch)
             for pkg in PKG}
    assert acked["ref"] == acked["port"]
    other = {"ref": "port", "port": "ref"}
    for pkg in PKG:
        # each reader gets its own copy: a recovery bumps epochs
        shutil.copytree(tmp_path / pkg, tmp_path / f"{pkg}-x")
    cross = {pkg: _state(other[pkg], tmp_path / f"{pkg}-x") for pkg in PKG}
    own = {pkg: _state(pkg, tmp_path / pkg) for pkg in PKG}
    for pkg in PKG:
        assert cross[pkg] == own[pkg]
        for d in DOCS:
            vals = set(own[pkg][d][0])
            assert not [v for v in acked[pkg][d] if v not in vals], \
                f"{pkg}/{site}/{d} lost acked writes"
    assert own["ref"] == own["port"]


def test_shared_prom_families_match_reference(tmp_path):
    """A shared-stream engine renders the reference's family set under
    the port's strict parser: the ``crdt_wal_shared_*`` families, and
    none of the per-document stream series (they would repeat the one
    stream's totals once a document).  A per-document engine renders no
    ``crdt_wal_shared_*`` family."""
    fams = {}
    for pkg, parse in (("ref", jprom.parse_text),
                       ("port", tprom.parse_text)):
        eng = _engine(pkg, tmp_path / pkg)
        try:
            for k, d in enumerate(DOCS):
                assert eng.submit(d, _body(pkg, k + 1, 5))[0]
            assert eng.flush(JOIN_S)
            fams[pkg] = parse(eng.render_prom())
        finally:
            eng.close()
    assert set(fams["port"]) == set(fams["ref"])
    shared = {f for f in fams["port"] if f.startswith("crdt_wal_shared_")}
    assert shared >= {"crdt_wal_shared_fsyncs_total",
                      "crdt_wal_shared_appends_total",
                      "crdt_wal_shared_covered_docs",
                      "crdt_wal_shared_fsync_ms",
                      "crdt_wal_shared_size_bytes",
                      "crdt_wal_shared_docs_marked"}
    for fam in ("crdt_wal_fsyncs_total", "crdt_wal_errors_total",
                "crdt_wal_size_bytes", "crdt_wal_fsync_ms"):
        assert fam not in fams["port"], fam
    covered = fams["port"]["crdt_scheduler_wal_shared_covered_docs_total"]
    assert covered["samples"][0][2] >= len(DOCS)
    eng = ServingEngine(durable_dir=str(tmp_path / "perdoc"),
                        wal_sync="batch", device="cpu", oplog_hot_ops=8)
    try:
        assert eng.shared_wal is None
        assert eng.submit("d", _body("port", 1, 5))[0]
        assert eng.flush(JOIN_S)
        per = tprom.parse_text(eng.render_prom())
        assert not any(f.startswith("crdt_wal_shared_") for f in per)
        assert "crdt_wal_fsyncs_total" in per
    finally:
        eng.close()
