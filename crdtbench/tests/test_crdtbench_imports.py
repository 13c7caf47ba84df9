"""No process the benchmark starts loads JAX or the JAX package: the
check compares top-level names whole, and the reference imports nothing
of the program."""
import subprocess
import sys
import textwrap

from crdtbench import run

ROOT = str(run.HERE.parent)


def test_banned_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "crdt_graph_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    assert "crdt_graph_tpu" not in run.banned_loaded()
    monkeypatch.setitem(sys.modules, "crdt_graph_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    found = run.banned_loaded()
    assert "crdt_graph_tpu" in found and "jax" in found
    assert "jaxfoo" not in found


def _fresh(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_harness_and_program_load_no_jax():
    got = _fresh("""
        import crdtbench.run as r, crdtbench.control
        import crdtbench.drivers.catchup, crdtbench.kernelwork
        import crdt_graph_tpu_torch.engine
        import crdt_graph_tpu_torch.utils.chainaudit
        print(r.banned_loaded())
    """)
    assert got == "[]"


def test_reference_imports_nothing_of_the_program():
    got = _fresh("""
        import sys
        import crdtbench.reference.rga, crdtbench.reference.check
        print(sorted({m.split('.')[0] for m in sys.modules}
                     & {'crdt_graph_tpu_torch', 'crdt_graph_tpu', 'jax',
                        'torch'}))
    """)
    assert got == "[]"
