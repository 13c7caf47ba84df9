"""Helpers of the headline entry points' tests: the reference script
of the same name (``scripts/<name>.py``, loaded by path, as the
reference's own tests load it), its committed output, and the key
comparison between a port output and a reference one."""
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ref_script(name):
    """The reference's ``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def committed(name):
    """The reference's committed output ``BENCH_<NAME>_r01_cpu.json``."""
    with open(os.path.join(ROOT, f"BENCH_{name}_r01_cpu.json")) as f:
        return json.load(f)


def assert_keys_cover(port, ref, path="", depth=2):
    """Every key of ``ref`` is a key of ``port``, recursing ``depth``
    levels into the dicts both hold under the same key."""
    missing = set(ref) - set(port)
    assert not missing, f"{path or 'top'}: port output lacks {missing}"
    if depth <= 0:
        return
    for k, v in ref.items():
        if isinstance(v, dict) and isinstance(port.get(k), dict):
            assert_keys_cover(port[k], v, f"{path}.{k}", depth - 1)


def run_gated(fn, out_path):
    """``fn()``; where it raised ``SpeedGateFailed`` after writing
    ``out_path`` (a ratio set on the reference's hardware, not
    reachable at a test's tiny size), the output it wrote.  Any other
    raise, a correctness check's included, propagates."""
    from crdt_graph_tpu_torch.scripts._headline import SpeedGateFailed
    try:
        return fn()
    except SpeedGateFailed:
        if not os.path.exists(out_path):
            raise
        with open(out_path) as f:
            out = json.load(f)
        assert not out["gate"]["pass"], "raised with its gate passing"
        return out
