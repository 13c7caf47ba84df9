"""The PyTorch port stands alone: it imports and merges with ``jax``
blocked, none of its sources (nor ``chip_smoke.py``) imports ``jax`` or
the JAX package, and its entry point never falls back to the CPU
quietly."""
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
