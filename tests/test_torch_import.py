"""The PyTorch port stands alone: it imports and merges with ``jax``
blocked (the durability modules and the native codec included), none of
its sources (nor ``chip_smoke.py``) imports ``jax`` or the JAX package,
and its entry point never falls back to the CPU quietly."""
import ast
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
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "for m, v in sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['c', 'a', 'b']"


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


def test_materialize_without_device_refuses_cpu_fallback():
    from crdt_graph_tpu_torch.bench import workloads
    from crdt_graph_tpu_torch.ops import merge
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        merge.materialize(workloads.chain_workload(4, 64))
    from crdt_graph_tpu_torch import engine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.init(1)
