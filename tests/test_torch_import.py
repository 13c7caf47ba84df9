"""The PyTorch port stands alone: it imports and merges with ``jax``
blocked (the ops-axis sharded merge, the durability modules, the native
codec, the serving stack — ``serve``, ``service``, ``obs`` and
``parallel.mesh`` — the benches and document models, and the
multi-device layer included), none of
its sources (nor ``chip_smoke.py``) imports ``jax`` or the JAX package,
and its entry point never falls back to the CPU quietly."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "crdt_graph_tpu_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "crdt_graph_tpu"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_imports_and_merges_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['crdt_graph_tpu'] = None\n"
        "import crdt_graph_tpu_torch\n"
        "from crdt_graph_tpu_torch import Add\n"
        "from crdt_graph_tpu_torch.codec import packed\n"
        "from crdt_graph_tpu_torch.ops import merge, view\n"
        "p = packed.pack([Add(1, (0,), 'a'), Add(2, (1,), 'b'),"
        " Add(3, (0,), 'c')])\n"
        "t = view.to_host(merge.materialize(p.arrays(), device='cpu'))\n"
        "print(view.visible_values(t, p.values))\n"
        "from crdt_graph_tpu_torch.parallel import opsaxis\n"
        "s = view.to_host(opsaxis.materialize(p.arrays(), k=4,"
        " device='cpu'))\n"
        "assert view.visible_values(s, p.values) == "
        "view.visible_values(t, p.values)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "for m, v in sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['c', 'a', 'b']"


def test_packed_formats_need_no_engine(tmp_path):
    """The op log, the WAL and the merge tier's wire codec write and read
    the packed formats (``codec.packed``) without the replica engine: with
    the ``__init__`` of the package, of ``mergetier`` and of ``serve``
    (which import the engine and the serving stack) left out and the
    engine blocked, a WAL record and a merge request round-trip, a log
    spills a cold segment, and its windows equal those of one
    packing."""
    stubs = {"crdt_graph_tpu_torch": str(PORT)}
    for sub in ("mergetier", "serve"):
        stubs[f"crdt_graph_tpu_torch.{sub}"] = str(PORT / sub)
    code = (
        "import sys, types\n"
        f"for name, path in {stubs!r}.items():\n"
        "    sys.modules[name] = types.ModuleType(name)\n"
        "    sys.modules[name].__path__ = [path]\n"
        "sys.modules['crdt_graph_tpu_torch.engine'] = None\n"
        "from crdt_graph_tpu_torch import oplog, wal\n"
        "from crdt_graph_tpu_torch.codec import packed\n"
        "from crdt_graph_tpu_torch.core.operation import Add\n"
        "from crdt_graph_tpu_torch.mergetier import wire\n"
        "ops = [Add(2**32 + i, (2**32 + i - 1 if i > 1 else 0,), i)"
        " for i in range(1, 41)]\n"
        "p = packed.pack(ops)\n"
        "end, q = wal._decode_payload(wal._encode_payload(p, 40))\n"
        "assert end == 40 and q.num_ops == 40\n"
        "r, meta = wire.decode_request(wire.encode_request('d', p, 40))\n"
        "assert meta['doc_id'] == 'd' and r.num_ops == 40\n"
        "log = oplog.OpLog(ops)\n"
        f"log.enable_tiering({str(tmp_path)!r}, hot_ops=16)\n"
        "log.maybe_spill()\n"
        "assert log.spills >= 1\n"
        "view = log.view()\n"
        "full = view.to_packed()\n"
        "for since in (0, ops[9].ts, ops[30].ts):\n"
        "    assert view.window(since, 7) == "
        "packed.packed_since_window(full, since, 7)\n"
        "    assert view.since_bytes(since) == "
        "packed.packed_since_bytes(full, since)\n"
        "print(sorted(m for m in sys.modules"
        " if m.startswith('crdt_graph_tpu_torch.engine')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['crdt_graph_tpu_torch.engine']"


def test_engine_modules_import_and_run_with_jax_blocked():
    """The engine, the op log, the host mirror and the oracle import with
    ``jax`` and the reference package blocked, and a replica session runs
    on the CPU path (a bulk merge included) and matches the oracle."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['crdt_graph_tpu'] = None\n"
        "import crdt_graph_tpu_torch as c\n"
        "from crdt_graph_tpu_torch import convert, engine, host_tree, oplog\n"
        "from crdt_graph_tpu_torch.core import node, tree\n"
        "t = c.init(1, device='cpu')\n"
        "t.add('a').add_branch('b').add('c')\n"
        "ops = [c.Add(2 * 2**32 + i, ((2 * 2**32 + i - 1) if i > 1 else 0,),"
        " i) for i in range(1, 1101)]\n"
        "t.apply(c.Batch(tuple(ops)))\n"
        "o = c.CRDTree.init(1).apply(t.operations_since(0))\n"
        "assert t.visible_values() == o.visible_values()\n"
        "assert isinstance(t._log, oplog.OpLog)\n"
        "assert convert.replica_state_to_numpy(t)['log_length'] == 1103\n"
        "print(len(t))\n"
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "for m, v in sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1103"


def test_durability_modules_import_and_run_with_jax_blocked(tmp_path):
    """The native codec, the WAL and the tiered op log import with
    ``jax`` and the reference package blocked, and a durable session
    (native ingest, tiered checkpoint, WAL replay) runs on the CPU path.
    Building the port's native codec writes nothing under the reference
    package."""
    ref_pkg = ROOT / "crdt_graph_tpu"

    def ref_files():
        # bytecode caches and the reference's own build of its codec
        # are the reference package's business (other test workers may
        # write them concurrently); anything else must stay untouched
        return {p: p.stat().st_mtime_ns for p in ref_pkg.rglob("*")
                if "__pycache__" not in p.parts
                and p.name != "_fastcodec.so"}

    before = ref_files()
    d = str(tmp_path / "dur")
    fresh = tmp_path / "native-build"
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['crdt_graph_tpu'] = None\n"
        "import crdt_graph_tpu_torch as c\n"
        "from crdt_graph_tpu_torch import engine, native, oplog, wal\n"
        "from crdt_graph_tpu_torch.codec import json_codec, packed\n"
        "from crdt_graph_tpu_torch.serve import metrics\n"
        f"native.BUILD_ROOT = Path({str(fresh)!r})\n"
        "assert native.available(), native._build_error\n"
        "assert native.so_path().exists()\n"
        f"d = {d!r}\n"
        "t = c.init(1, device='cpu')\n"
        "t.enable_log_tiering(d, hot_ops=64, durable=True)\n"
        "ops = [c.Add(2 * 2**32 + i, ((2 * 2**32 + i - 1) if i > 1 else 0,),"
        " i) for i in range(1, 1201)]\n"
        "t.apply_wire(json_codec.dumps(c.Batch(tuple(ops))).encode())\n"
        "assert native.calls['parse_pack'] == 1\n"
        "t.checkpoint_tiered(d)\n"
        "w = wal.Wal(d + '/wal.log')\n"
        "tail = [c.Add(3 * 2**32 + i, ((3 * 2**32 + i - 1) if i > 1 else 0,),"
        " -i) for i in range(1, 41)]\n"
        "w.append(packed.pack(tail), 1240)\n"
        "w.sync()\n"
        "r = engine.TpuTree.restore_tiered(d, device='cpu')\n"
        "st = w.replay_into(r)\n"
        "t.apply(c.Batch(tuple(tail)))\n"
        "assert r.visible_values() == t.visible_values()\n"
        "assert r.dumps_since_bytes(0) == t.dumps_since_bytes(0)\n"
        "assert isinstance(r._log, oplog.OpLog) and r._log.tiering_enabled\n"
        "print(st['ops'], r.log_length)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "or m.startswith('crdt_graph_tpu.') "
        "for m, v in sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "40 1240"
    assert ref_files() == before, "building the port touched crdt_graph_tpu/"
    built = list(fresh.rglob("_fastcodec.so"))
    assert len(built) == 1, built
    from crdt_graph_tpu_torch import native
    assert ref_pkg not in native.so_path().parents


def test_serving_stack_imports_and_serves_with_jax_blocked(tmp_path):
    """``serve``, ``service``, ``obs`` and ``parallel.mesh`` import with
    ``jax`` and the reference package blocked; the HTTP server answers a
    durable session on the CPU path (a batched merge of two documents
    included) and a restart serves every acked write."""
    d = str(tmp_path / "srv")
    code = (
        "import sys, json\n"
        "from http.client import HTTPConnection\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['crdt_graph_tpu'] = None\n"
        "import threading\n"
        "import crdt_graph_tpu_torch as c\n"
        "from crdt_graph_tpu_torch import obs, serve, service\n"
        "from crdt_graph_tpu_torch.obs import prom\n"
        "from crdt_graph_tpu_torch.parallel import mesh\n"
        "from crdt_graph_tpu_torch.codec import json_codec\n"
        "def chain(r, n):\n"
        "    return json_codec.dumps(c.Batch(tuple(c.Add(r * 2**32 + i,"
        " ((r * 2**32 + i - 1) if i > 1 else 0,), i)"
        " for i in range(1, n + 1))))\n"
        f"d = {d!r}\n"
        "eng = serve.ServingEngine(device='cpu', durable_dir=d,"
        " wal_sync='commit', start=False, submit_timeout_s=60)\n"
        "out = {}\n"
        "ths = [threading.Thread(target=lambda k=k: out.__setitem__(k,"
        " eng.submit(k, chain(k == 'a' and 2 or 3, 1100))))"
        " for k in ('a', 'b')]\n"
        "[t.start() for t in ths]\n"
        "import time\n"
        "while sum(len(eng.get(k).queue) for k in ('a', 'b')) < 2:\n"
        "    time.sleep(0.01)\n"
        "assert eng.scheduler.step() == 2\n"
        "[t.join(60) for t in ths]\n"
        "assert eng.counters.get('cross_doc_batches') == 1\n"
        "eng.scheduler.start()\n"
        "srv = service.make_server(port=0, store=eng)\n"
        "th = threading.Thread(target=srv.serve_forever, daemon=True)\n"
        "th.start()\n"
        "conn = HTTPConnection('127.0.0.1', srv.server_port, timeout=60)\n"
        "conn.request('POST', '/docs/a/ops', body=chain(5, 3))\n"
        "r = conn.getresponse(); body = json.loads(r.read())\n"
        "assert r.status == 200 and body['applied_count'] == 3, body\n"
        "conn.request('GET', '/metrics/prom')\n"
        "prom.parse_text(conn.getresponse().read().decode())\n"
        "conn.close(); srv.shutdown(); srv.server_close(); eng.close()\n"
        "th.join(60)\n"
        "eng2 = serve.ServingEngine(device='cpu', durable_dir=d,"
        " wal_sync='commit')\n"
        "print(len(eng2.get('a').snapshot()), len(eng2.get('b').snapshot()))\n"
        "eng2.close()\n"
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "or m.startswith('crdt_graph_tpu.') "
        "for m, v in sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), GRAFT_OBS_AUDIT_EVERY="0")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1103 1100"


def test_materialize_without_device_refuses_cpu_fallback():
    from crdt_graph_tpu_torch.bench import workloads
    from crdt_graph_tpu_torch.ops import merge
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        merge.materialize(workloads.chain_workload(4, 64))
    from crdt_graph_tpu_torch.parallel import opsaxis
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opsaxis.materialize(workloads.chain_workload(4, 64), k=2)
    from crdt_graph_tpu_torch import engine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.init(1)
    from crdt_graph_tpu_torch.parallel import mesh
    from crdt_graph_tpu_torch.codec import packed
    from crdt_graph_tpu_torch import Add
    p = packed.pack([Add(1, (0,), "a")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.batched_materialize(mesh.stack_packed([p]))
    from crdt_graph_tpu_torch import serve, service
    for make in (serve.ServingEngine, service.DocumentStore,
                 service.make_server):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_fleet_and_merge_tier_import_and_run_with_jax_blocked():
    """``cluster``, ``mergetier`` and ``obs.fleettrace`` / ``ledger`` /
    ``canary`` import with ``jax`` and the reference package blocked;
    a 2-node fleet on the CPU path ships a giant write, entered through
    the non-primary, to a merge worker over HTTP and converges by
    anti-entropy."""
    code = (
        "import sys, json\n"
        "from http.client import HTTPConnection\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['crdt_graph_tpu'] = None\n"
        "import crdt_graph_tpu_torch as c\n"
        "from crdt_graph_tpu_torch import cluster, mergetier\n"
        "from crdt_graph_tpu_torch.cluster import mergepool\n"
        "from crdt_graph_tpu_torch.obs import canary, fleettrace, ledger\n"
        "from crdt_graph_tpu_torch.codec import json_codec\n"
        "from crdt_graph_tpu_torch.mergetier.worker import "
        "MergeWorkerServer\n"
        "from crdt_graph_tpu_torch.serve import ServingEngine\n"
        "kv = cluster.MemoryKV()\n"
        "ws = MergeWorkerServer(device='cpu')\n"
        "mergepool.register(kv, 'w0', ws.addr)\n"
        "fleet = {}\n"
        "for n in ('n0', 'n1'):\n"
        "    mt = mergetier.MergeTierClient.from_env(src=n, kv=kv)\n"
        "    eng = ServingEngine(device='cpu', mergetier=mt)\n"
        "    fleet[n] = cluster.FleetServer(n, kv, engine=eng,"
        " ttl_s=600.0, ae_interval_s=3600.0)\n"
        "ring = fleet['n0'].node.refresh_ring()\n"
        "doc = next(f'd{i}' for i in range(99)"
        " if ring.primary(f'd{i}') == 'n1')\n"
        "ops = tuple(c.Add(3 * 2**32 + i, ((3 * 2**32 + i - 1)"
        " if i > 1 else 0,), i) for i in range(1, 4201))\n"
        "conn = HTTPConnection('127.0.0.1', fleet['n0'].port, timeout=60)\n"
        "conn.request('POST', f'/docs/{doc}/ops',"
        " body=json_codec.dumps(c.Batch(ops)))\n"
        "r = conn.getresponse(); ack = json.loads(r.read()); conn.close()\n"
        "assert r.status == 200 and ack['served_by']['name'] == 'n1', ack\n"
        "fleet['n0'].node.antientropy.sync_now()\n"
        "fps = {n: fs.node.engine.get(doc).read_view().state_fingerprint()"
        " for n, fs in fleet.items()}\n"
        "assert len(set(fps.values())) == 1, fps\n"
        "st = fleet['n1'].node.engine.mergetier.stats()\n"
        "assert st['remote_docs'] == 1 and not st['fallbacks'], st\n"
        "print(ws.worker.stats()['merged_docs'],"
        " len(fleet['n0'].node.engine.get(doc).snapshot()))\n"
        "for fs in fleet.values():\n"
        "    fs.stop()\n"
        "ws.stop()\n"
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "or m.startswith('crdt_graph_tpu.') "
        "for m, v in sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), GRAFT_OBS_AUDIT_EVERY="0")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr
    # n1's commit and n0's anti-entropy pull both ship as giant singles
    assert out.stdout.strip() == "2 4200"


def test_fleet_entry_points_refuse_cpu_fallback(tmp_path):
    """The merge worker, its server and the fleet node build their
    engines on the card; without one they raise unless the caller asks
    for the CPU.  ``python -m crdt_graph_tpu_torch.cluster`` likewise
    raises without ``--cpu`` and serves with it, here durable on one
    shared WAL stream (``--wal-shared``): a write acks, reads back, and
    its record lands in ``wal-shared.log``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    from crdt_graph_tpu_torch import cluster
    from crdt_graph_tpu_torch.mergetier import MergeWorker
    from crdt_graph_tpu_torch.mergetier.worker import MergeWorkerServer
    for make in (MergeWorker, MergeWorkerServer,
                 lambda: cluster.ClusterNode("n0", cluster.MemoryKV()),
                 lambda: cluster.FleetServer("n0", cluster.MemoryKV())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "crdt_graph_tpu_torch.cluster",
           "--name", "n0", "--kv-dir", str(tmp_path / "kv"), "--port", "0"]
    out = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    ddir = tmp_path / "dur"
    proc = subprocess.Popen(cmd + ["--cpu", "--wal-shared", "--durable-dir",
                                   str(ddir)], cwd=str(ROOT), env=env,
                            stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("READY "), line
        ready = json.loads(line[len("READY "):])
        assert ready["name"] == "n0" and ready["id"] == 0
        assert ready["epoch"] == 1
        import urllib.request
        base = f"http://{ready['addr']}"
        body = json.dumps({"op": "add", "ts": 2**32 + 1, "path": [0],
                           "val": "w"}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"{base}/docs/d/ops", data=body, method="POST"),
                timeout=60) as r:
            assert json.loads(r.read())["accepted"]
        with urllib.request.urlopen(f"{base}/docs/d", timeout=60) as r:
            assert json.loads(r.read())["values"] == ["w"]
        from crdt_graph_tpu_torch import wal
        assert os.path.getsize(ddir / "wal-shared.log") > len(
            wal.SHARED_MAGIC)
        assert not (ddir / "doc-d" / "wal.log").exists()
    finally:
        proc.terminate()
        assert proc.wait(60) == 0


def test_benches_and_models_import_and_run_with_jax_blocked():
    """``bench.runner``, ``incremental``, ``serving``, ``loadgen`` and
    ``models`` import with ``jax`` and the reference package blocked,
    and a config-1 runner row runs on the CPU path, order-exact."""
    code = (
        "import sys, json\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['crdt_graph_tpu'] = None\n"
        "from crdt_graph_tpu_torch.bench import incremental, loadgen,"
        " runner, serving\n"
        "from crdt_graph_tpu_torch import models\n"
        "from crdt_graph_tpu_torch.models import OutlineDoc, TextBuffer\n"
        "buf = TextBuffer(1, device='cpu')\n"
        "buf.insert(0, 'abc')\n"
        "assert buf.text() == 'abc'\n"
        "(row,) = runner.run([1], repeats=1, device='cpu')\n"
        "assert row['order_check'] == 'exact' and row['audit']['ok']\n"
        "print(row['n_ops'], row['num_nodes'], row['num_visible'],"
        " file=sys.stderr)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "or m.startswith('crdt_graph_tpu.') "
        "for m, v in sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stderr.strip().splitlines()[-1] == "1000 732 464"


def test_bench_entry_points_refuse_cpu_fallback():
    """The runner, the models' ``tpu`` engine, the incremental and
    serving benches and both load-generator modes run on the card; with
    no ``device=`` they raise without one, and so does ``python -m
    crdt_graph_tpu_torch.bench`` without ``--device cpu``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    from crdt_graph_tpu_torch.bench import incremental, loadgen, runner, \
        serving
    from crdt_graph_tpu_torch.models import OutlineDoc, TextBuffer
    for make in (lambda: runner.run([1], repeats=1),
                 lambda: runner.headline(),
                 lambda: TextBuffer(1, engine="tpu"),
                 lambda: OutlineDoc(1),
                 lambda: incremental.run((10,), n_ops=1),
                 lambda: incremental.run_bulk((10,), (300,)),
                 lambda: serving.run(1, 0.1),
                 lambda: loadgen.run(loadgen.LoadgenConfig()),
                 lambda: loadgen.run_fleet(loadgen.LoadgenConfig(
                     n_servers=3))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert TextBuffer(1, engine="oracle").text() == ""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for mod in ("crdt_graph_tpu_torch.bench",
                "crdt_graph_tpu_torch.bench.incremental",
                "crdt_graph_tpu_torch.bench.loadgen"):
        out = subprocess.run([sys.executable, "-m", mod], cwd=str(ROOT),
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0 and "no CUDA device" in out.stderr, mod


# the headline entry points (each with ``main(argv)`` and ``--device``);
# ``fuzz_native`` is a host tool beside them (no card, no ``--device``)
HOST_TOOLS = ("fuzz_native",)
SCRIPTS = sorted(p.stem for p in (PORT / "scripts").glob("*.py")
                 if not p.stem.startswith("_") and p.stem not in HOST_TOOLS)


def test_headline_scripts_import_with_jax_blocked():
    """Every module of ``crdt_graph_tpu_torch.scripts`` imports with
    ``jax`` and the reference package blocked."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['crdt_graph_tpu'] = None\n"
        f"for name in {SCRIPTS!r}:\n"
        "    importlib.import_module('crdt_graph_tpu_torch.scripts.' + name)\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('crdt_graph_tpu_torch.scripts.')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= len(SCRIPTS) == 19


def test_broadcast_child_imports_no_torch():
    """The broadcast headline's client drivers run its file with
    ``--child`` on the standard library alone: ``torch`` (and so any
    CUDA context) blocked, a driver of no watchers still runs and
    reports."""
    path = PORT / "scripts" / "bench_broadcast_headline.py"
    code = (
        "import runpy, sys\n"
        "sys.modules['torch'] = None\n"
        "sys.modules['numpy'] = None\n"
        f"sys.argv = [{str(path)!r}, '--child', '1', 'd', '0', '0', '1']\n"
        f"runpy.run_path({str(path)!r}, run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    assert stats["count"] == 0 and stats["errors"] == []


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the entry points without a card")
def test_headline_entry_point_without_card_exits_and_writes_nothing(
        tmp_path, monkeypatch):
    """With no card and no ``--device``, every headline entry point exits
    non-zero before it runs or writes anything (``python -m`` for one,
    ``main([])`` for all 19); ``--device cpu`` is the plain path."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m",
         "crdt_graph_tpu_torch.scripts.bench_serve_headline"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 2, (out.stdout, out.stderr)
    assert "no CUDA device" in out.stderr and out.stdout == ""
    import importlib
    from crdt_graph_tpu_torch.scripts import _headline
    monkeypatch.setattr(_headline, "OUT_DIR", tmp_path / "headline")
    for name in SCRIPTS:
        mod = importlib.import_module(f"crdt_graph_tpu_torch.scripts.{name}")
        with pytest.raises(SystemExit) as e:
            mod.main([])
        assert e.value.code == 2, name
    assert not (tmp_path / "headline").exists()


def test_multidevice_modules_import_and_run_with_jax_blocked():
    """The multi-device layer (``parallel.shard``, ``parallel.distributed``,
    ``parallel.dryrun``, ``parallel.collectives``), the docs-axis headline
    and the fuzz harness import with ``jax`` and the reference package
    blocked, and the dry run passes on 8 logical CPU devices."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['crdt_graph_tpu'] = None\n"
        "from crdt_graph_tpu_torch.parallel import (collectives,"
        " distributed, dryrun, shard, dryrun_multichip, make_mesh,"
        " sharded_materialize, shard_materialize, measure_collectives)\n"
        "from crdt_graph_tpu_torch.scripts import bench_docs_axis,"
        " fuzz_native\n"
        "out = dryrun_multichip(8, device='cpu')\n"
        "print(out['mesh'], out['ops'] >= 10000)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "for m, v in sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "{'docs': 4, 'ops': 2} True"
