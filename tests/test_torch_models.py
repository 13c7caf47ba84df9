"""The port's document models, held to the reference's.

- **Lockstep**: one seeded editor session (single and multi-character
  inserts, range deletes, remote merges between two replicas, one paste
  large enough to take the bulk merge) runs on the reference's and the
  port's ``TextBuffer``, and a seeded outline session (sections, nested
  items, subtree deletes, concurrent edits and merges) on their
  ``OutlineDoc``, all with ``engine="tpu"`` (the port's on
  ``device="cpu"``).  After every step ``text()`` / ``items()`` agree,
  each step's delta has byte-identical wire JSON, and so does
  ``operations_since(0)`` of every replica at the end.
- **Replay**: each test of the reference's ``tests/test_text_model.py``
  and ``tests/test_outline_model.py`` runs again with its names pointed
  at the port; the tests that take the ``eng`` fixture run once for
  each engine.
"""
import functools
import inspect
import random
import types

import pytest

import test_outline_model as ref_outline  # noqa: E402 — JAX on CPU
import test_text_model as ref_text  # noqa: E402
import _torch_replay  # noqa: E402

from crdt_graph_tpu.codec import json_codec as jjson  # noqa: E402
from crdt_graph_tpu.models import OutlineDoc as JOutline  # noqa: E402
from crdt_graph_tpu.models import TextBuffer as JText  # noqa: E402

from crdt_graph_tpu_torch import engine as tengine  # noqa: E402
from crdt_graph_tpu_torch.codec import json_codec as tjson  # noqa: E402
from crdt_graph_tpu_torch.models import OutlineDoc as TOutline  # noqa: E402
from crdt_graph_tpu_torch.models import TextBuffer as TText  # noqa: E402

TText_cpu = functools.partial(TText, device="cpu")
TOutline_cpu = functools.partial(TOutline, device="cpu")
PASTE = 1100          # a remote paste past the host-first limit (1,024)


class Pair:
    """The same replica in both packages, driven in lockstep."""

    def __init__(self, jdoc, tdoc):
        self.j, self.t = jdoc, tdoc

    def step(self, fn):
        """Apply ``fn`` to both; their deltas' wire bytes must agree."""
        jd, td = fn(self.j), fn(self.t)
        if jd is not None or td is not None:
            assert tjson.dumps(td) == jjson.dumps(jd)
        return jd, td

    def merge_from(self, other):
        """Pull ``other``'s news into this replica in both packages."""
        self.j.sync_from(other.j)
        self.t.sync_from(other.t)


def _wire_since_zero(pair):
    return (jjson.dumps(pair.j.operations_since(0)),
            tjson.dumps(pair.t.operations_since(0)))


def test_text_session_lockstep():
    rng = random.Random(2024)
    a = Pair(JText(3, engine="tpu"), TText_cpu(3, engine="tpu"))
    b = Pair(JText(5, engine="tpu"), TText_cpu(5, engine="tpu"))
    bulk_seen = False
    for k in range(160):
        me, peer = (a, b) if rng.random() < 0.6 else (b, a)
        n = len(me.t)
        assert len(me.j) == n
        r = rng.random()
        if k == 80:
            # a paste on b, merged into a as one remote batch
            text = "".join(chr(65 + i % 26) for i in range(PASTE))
            b.step(lambda d: d.insert(len(d), text))
            a.merge_from(b)
            bulk_seen = True
        elif n and r < 0.3:
            i = rng.randrange(n)
            cnt = rng.randint(1, min(4, n - i))
            me.step(lambda d: d.delete(i, cnt))
        elif r < 0.8:
            i = rng.randrange(n + 1)
            chunk = "".join(chr(97 + rng.randrange(26))
                            for _ in range(rng.randint(1, 6)))
            me.step(lambda d: d.insert(i, chunk))
        else:
            me.merge_from(peer)
        for p in (a, b):
            assert p.t.text() == p.j.text()
            assert len(p.t) == len(p.j)
    a.merge_from(b)
    b.merge_from(a)
    assert bulk_seen and a.t.text() == b.t.text() == a.j.text()
    for p in (a, b):
        jw, tw = _wire_since_zero(p)
        assert tw == jw
    # the paste reached a's replica as one bulk merge of the log
    assert a.t._t.log_length == a.j._t.log_length


def test_outline_session_lockstep():
    rng = random.Random(77)
    a = Pair(JOutline(2, engine="tpu"), TOutline_cpu(2, engine="tpu"))
    b = Pair(JOutline(9, engine="tpu"), TOutline_cpu(9, engine="tpu"))
    for k in range(120):
        me, peer = (a, b) if rng.random() < 0.5 else (b, a)
        items = me.t.items()
        assert items == me.j.items()
        r = rng.random()
        if items and r < 0.15:
            path = rng.choice(items)[2]
            me.step(lambda d: d.delete_item(path))
        elif r < 0.75:
            label = f"i{k}"
            parent = after = None
            if items and rng.random() < 0.5:
                parent = rng.choice(items)[2]
            elif items and rng.random() < 0.5:
                after = rng.choice(items)[2]
            got = {}

            def add(d, _key):
                got[_key] = d.add_item(label, parent=parent, after=after)
                return d.last_operation
            me.step(lambda d: add(d, "t" if d is me.t else "j"))
            assert got["t"] == got["j"]
        else:
            me.merge_from(peer)
        for p in (a, b):
            assert p.t.items() == p.j.items()
            assert p.t.render() == p.j.render()
    a.merge_from(b)
    b.merge_from(a)
    assert a.t.items() == b.t.items() == a.j.items()
    for p in (a, b):
        jw, tw = _wire_since_zero(p)
        assert tw == jw


ENGINE = types.SimpleNamespace(
    init=functools.partial(tengine.init, device="cpu"))
MODULES = (("crdt_graph_tpu.engine", ENGINE),
           ("crdt_graph_tpu.codec.json_codec", tjson),
           ("crdt_graph_tpu.models.text",
            types.SimpleNamespace(TextBuffer=TText_cpu)))


def _eng_cases(ref):
    """(test name, engine) for each test of ``ref`` that takes the
    ``eng`` fixture."""
    return [pytest.param(name, e, id=f"{name}[{e}]")
            for name, fn in sorted(vars(ref).items())
            if name.startswith("test_")
            and set(inspect.signature(fn).parameters) == {"eng"}
            for e in ("oracle", "tpu")]


@pytest.mark.parametrize("name,index",
                         _torch_replay.cases(ref_text, set()))
def test_text_model_test_passes_on_port(name, index, tmp_path, monkeypatch):
    _torch_replay.run(ref_text, name, index, tmp_path, monkeypatch,
                      names=(("TextBuffer", TText_cpu),), modules=MODULES)


@pytest.mark.parametrize("name,eng", _eng_cases(ref_text))
def test_text_model_engine_test_passes_on_port(name, eng, tmp_path,
                                               monkeypatch):
    _torch_replay.run(ref_text, name, None, tmp_path, monkeypatch,
                      names=(("TextBuffer", TText_cpu),), modules=MODULES,
                      fixtures={"eng": eng})


@pytest.mark.parametrize("name,index",
                         _torch_replay.cases(ref_outline, set()))
def test_outline_model_test_passes_on_port(name, index, tmp_path,
                                           monkeypatch):
    _torch_replay.run(ref_outline, name, index, tmp_path, monkeypatch,
                      names=(("OutlineDoc", TOutline_cpu),), modules=MODULES)


@pytest.mark.parametrize("name,eng", _eng_cases(ref_outline))
def test_outline_model_engine_test_passes_on_port(name, eng, tmp_path,
                                                  monkeypatch):
    _torch_replay.run(ref_outline, name, None, tmp_path, monkeypatch,
                      names=(("OutlineDoc", TOutline_cpu),), modules=MODULES,
                      fixtures={"eng": eng})
