"""Re-running a reference test module's own tests against the port.

A reference test reaches the package only through its module's globals
(``FleetServer``, ``MergeWorker``, ``json_codec`` ...) and through
imports inside its body (``from crdt_graph_tpu.cluster import
netchaos``).  :func:`run` points both at the port for one test: the
globals by ``monkeypatch.setattr`` on the reference test module, the
in-body imports by putting the port's module in ``sys.modules`` (and on
the parent package) under the reference's name.  ``monkeypatch`` undoes
both when the test ends.
"""
import functools
import importlib
import inspect
import sys
import types

import pytest

FIXTURES = {"tmp_path", "monkeypatch"}
_PARAM = type(pytest.param(None))


def _slow(marks):
    return any(m.name == "slow" for m in marks)


def cases(ref, needs_more):
    """One ``pytest.param(name, index)`` for every test of ``ref`` not
    named in ``needs_more`` that asks for no fixture but ``tmp_path``
    and ``monkeypatch`` (and the names of its own ``parametrize`` mark,
    whose cases it expands).  A test or a case the reference marks
    ``slow`` is left out, as the reference's tier-1 run leaves it out."""
    out = []
    for name, fn in sorted(vars(ref).items()):
        if not name.startswith("test_") or name in needs_more:
            continue
        marks = getattr(fn, "pytestmark", [])
        if _slow(marks):
            continue
        params = [m for m in marks if m.name == "parametrize"]
        args = set(inspect.signature(fn).parameters)
        if not params:
            if args <= FIXTURES:
                out.append(pytest.param(name, None, id=name))
            continue
        (mark,) = params
        if not args <= FIXTURES | set(_argnames(mark)):
            continue
        ids = mark.kwargs.get("ids")
        for i, case in enumerate(mark.args[1]):
            if isinstance(case, _PARAM) and _slow(case.marks):
                continue
            tag = ids[i] if ids is not None else \
                (case.id if isinstance(case, _PARAM) else None) or str(i)
            out.append(pytest.param(name, i, id=f"{name}[{tag}]"))
    return out


def _argnames(mark):
    return [a.strip() for a in mark.args[0].split(",")] \
        if isinstance(mark.args[0], str) else list(mark.args[0])


def case_values(ref, name, index):
    """``{argument: value}`` of case ``index`` of ``ref.<name>``'s
    parametrize mark."""
    mark = next(m for m in getattr(ref, name).pytestmark
                if m.name == "parametrize")
    case = mark.args[1][index]
    argnames = _argnames(mark)
    if isinstance(case, _PARAM):
        values = case.values
    else:
        values = (case,) if len(argnames) == 1 else case
    return dict(zip(argnames, values))


def run(ref, name, index, tmp_path, monkeypatch, names=(), modules=(),
        fixtures=None):
    """Run ``ref.<name>`` (case ``index`` of its parametrize mark) with
    each ``(attribute, port_value)`` of ``names`` set on ``ref`` and each
    ``(reference_module_name, port_module)`` of ``modules`` standing in
    for the reference module; ``fixtures`` gives the values of any other
    fixture the test asks for."""
    for attr, value in names:
        assert hasattr(ref, attr), f"{ref.__name__} has no {attr}"
        monkeypatch.setattr(ref, attr, value)
    for ref_name, port_mod in modules:
        parent, leaf = ref_name.rsplit(".", 1)
        package = importlib.import_module(parent)
        monkeypatch.setitem(sys.modules, ref_name, port_mod)
        monkeypatch.setattr(package, leaf, port_mod, raising=False)
    fn = getattr(ref, name)
    given = {"tmp_path": tmp_path, "monkeypatch": monkeypatch,
             **(fixtures or {})}
    if index is not None:
        given.update(case_values(ref, name, index))
    fn(**{a: given[a] for a in inspect.signature(fn).parameters})


def port_loadgen():
    """A stand-in for the reference's ``bench.loadgen`` module: the
    port's, with every engine the harness builds itself on the CPU."""
    from crdt_graph_tpu_torch.bench import loadgen
    return types.SimpleNamespace(
        LoadgenConfig=functools.partial(loadgen.LoadgenConfig,
                                        device="cpu"),
        run=loadgen.run, run_fleet=loadgen.run_fleet)


LOADGEN = "crdt_graph_tpu.bench.loadgen"
