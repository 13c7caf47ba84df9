"""The port's host-shared encoded-body cache (``GRAFT_SHMCACHE``,
``serve/shmcache.py``), held to the reference's tests and to the
reference across packages.

Three tests of ``tests/test_shmcache.py`` run again with that module's
names pointed at the port (``ServingEngine(device="cpu")``, the codec,
``obs.prom``): two engines share one segment, a held memoryview
survives the publish swap, the release and the unlink, and the
``crdt_shmcache_*`` families parse only when the tier is armed.  The
other two need their port twins: the cross-process attach spawns a
child that imports the port, and the ``GRAFT_READCACHE=0`` bypass (a
switch the port does not take) becomes byte identity between an armed
engine and a default one.  Across packages, a reference engine and a
port engine in one namespace agree on the segment name: whichever
serves second attaches the first one's segment and serves its bytes.
"""
import functools
import hashlib
import json
import os
import subprocess
import sys
import uuid

import pytest

import test_shmcache as ref  # noqa: E402 — configures JAX for the CPU
import _torch_replay  # noqa: E402

from crdt_graph_tpu.codec import json_codec as jjson  # noqa: E402
from crdt_graph_tpu.core.operation import Add as JAdd  # noqa: E402
from crdt_graph_tpu.core.operation import Batch as JBatch  # noqa: E402
from crdt_graph_tpu.serve import ServingEngine as JEngine  # noqa: E402

from crdt_graph_tpu_torch.codec import json_codec as tjson  # noqa: E402
from crdt_graph_tpu_torch.core.operation import Add, Batch  # noqa: E402
from crdt_graph_tpu_torch.obs import prom as tprom  # noqa: E402
from crdt_graph_tpu_torch.serve import ServingEngine  # noqa: E402
from crdt_graph_tpu_torch.serve import shmcache as tshm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFF = 2**32
PORT_ENGINE = functools.partial(ServingEngine, device="cpu")
NAMES = (("ServingEngine", PORT_ENGINE), ("json_codec", tjson),
         ("Add", Add), ("Batch", Batch), ("prom_mod", tprom))
REPLAYED = ("test_two_engines_share_one_segment",
            "test_held_memoryview_survives_swap_release_and_unlink",
            "test_prom_shmcache_families_strict_parse")


@pytest.fixture()
def shm_ns(monkeypatch):
    """A namespace of this test's own, as the reference's fixture."""
    ns = f"t{uuid.uuid4().hex[:10]}"
    monkeypatch.setenv("GRAFT_SHMCACHE_NS", ns)
    return ns


@pytest.mark.parametrize("name", REPLAYED)
def test_shmcache_test_passes_on_port(name, shm_ns, tmp_path, monkeypatch):
    _torch_replay.run(ref, name, None, tmp_path, monkeypatch, names=NAMES,
                      fixtures={"shm_ns": shm_ns})


def _chain(add, n, rid=1):
    ops, prev = [], 0
    for c in range(1, n + 1):
        ops.append(add(rid * OFF + c, (prev,), f"v{rid}.{c}"))
        prev = rid * OFF + c
    return ops


def _port_engine(**kw):
    return ServingEngine(device="cpu", oplog_hot_ops=8, **kw)


def test_armed_bodies_equal_default_bodies(shm_ns, monkeypatch):
    """The port's twin of ``test_readcache_off_bypasses_both_tiers``:
    the shared tier serves the bytes a default (process-local) engine
    encodes, and a default engine arms no tier.  ``GRAFT_READCACHE=0``
    itself stays unported and raises."""
    armed = _port_engine(shmcache=True)
    plain = _port_engine()
    try:
        assert armed.shmcache is not None and plain.shmcache is None
        body = tjson.dumps(Batch(tuple(_chain(Add, 10))))
        for eng in (armed, plain):
            assert eng.submit("d", body)[0]
        a = armed.get("d").read_view()
        p = plain.get("d").read_view()
        assert isinstance(a.values_body(), memoryview)
        assert bytes(a.values_body()) == bytes(p.values_body())
        assert bytes(a.clock_body()) == bytes(p.clock_body())
        assert a.etag() == p.etag()
        assert a.shm_seg_name is not None and p.shm_seg_name is None
    finally:
        armed.close()
        plain.close()
    assert ref._shm_listing(shm_ns) == []
    monkeypatch.setenv("GRAFT_READCACHE", "0")
    with pytest.raises(NotImplementedError, match="GRAFT_READCACHE"):
        _port_engine(shmcache=True)


_CHILD = r"""
import hashlib, json, sys
sys.modules["jax"] = None
sys.modules["crdt_graph_tpu"] = None
from crdt_graph_tpu_torch.codec import json_codec
from crdt_graph_tpu_torch.core.operation import Add, Batch
from crdt_graph_tpu_torch.serve import ServingEngine

OFF = 2**32
ops, prev = [], 0
for c in range(1, 13):
    t = OFF + c
    ops.append(Add(t, (prev,), f"v1.{c}"))
    prev = t
eng = ServingEngine(oplog_hot_ops=8, shmcache=True, device="cpu")
assert eng.shmcache is not None
ok, _ = eng.submit("d", json_codec.dumps(Batch(tuple(ops))))
assert ok
snap = eng.get("d").read_view()
body = bytes(snap.values_body())
out = {"stats": eng.shmcache.stats.snapshot(),
       "seg": snap.shm_seg_name,
       "body_sha": hashlib.sha1(body).hexdigest()}
eng.close()
print(json.dumps(out))
"""


def test_cross_process_attach_single_encode(shm_ns):
    """The port's twin of the reference's cross-process test: a second
    PROCESS of the port (JAX and the reference blocked) converging on
    the same document attaches this one's segment — hits 1, misses 0,
    the same bytes."""
    eng = _port_engine(shmcache=True)
    assert eng.submit("d", tjson.dumps(Batch(tuple(_chain(Add, 12)))))[0]
    snap = eng.get("d").read_view()
    body = bytes(snap.values_body())
    assert snap.shm_seg_name is not None
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + env.get("PYTHONPATH", "").split(os.pathsep))
    proc = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["seg"] == snap.shm_seg_name
    assert got["stats"]["hits"] == 1 and got["stats"]["misses"] == 0
    assert got["body_sha"] == hashlib.sha1(body).hexdigest()
    st = eng.shmcache.stats.snapshot()
    assert st["misses"] == 1 and st["hits"] == 0
    eng.close()
    assert ref._shm_listing(shm_ns) == []


@pytest.mark.parametrize("first", ["ref", "port"])
def test_reference_and_port_share_one_segment(shm_ns, first):
    """A reference engine and a port engine in one namespace serving the
    same converged document: the one that reads first encodes (a miss),
    the other attaches the same segment (a hit) and serves identical
    value and clock bodies; after both close no segment is left."""
    engines = {"ref": JEngine(oplog_hot_ops=8, shmcache=True),
               "port": _port_engine(shmcache=True)}
    bodies = {"ref": jjson.dumps(JBatch(tuple(_chain(JAdd, 12)))),
              "port": tjson.dumps(Batch(tuple(_chain(Add, 12))))}
    assert bodies["ref"] == bodies["port"]
    second = "port" if first == "ref" else "ref"
    try:
        got = {}
        for pkg in (first, second):
            eng = engines[pkg]
            assert eng.shmcache is not None
            assert eng.submit("d", bodies[pkg])[0]
            snap = eng.get("d").read_view()
            got[pkg] = (bytes(snap.values_body()), bytes(snap.clock_body()),
                        snap.shm_seg_name, snap.state_fingerprint())
        assert got["ref"] == got["port"]
        assert got[first][2] == tshm.ShmBodyCache(shm_ns).seg_name(
            "d", got[first][3])
        st = {pkg: e.shmcache.stats.snapshot()
              for pkg, e in engines.items()}
        assert (st[first]["misses"], st[first]["hits"]) == (1, 0), st
        assert (st[second]["misses"], st[second]["hits"]) == (0, 1), st
        assert st[first]["attach_failed"] == st[second]["attach_failed"] \
            == 0
    finally:
        for e in engines.values():
            e.close()
    assert ref._shm_listing(shm_ns) == []
