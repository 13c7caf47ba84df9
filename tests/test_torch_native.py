"""The port's native wire codec against the reference package's, on the
CPU.

The same C++ source is built twice — the reference's build in its own
package, the port's into ``build/native/<hash>/`` — and both load into
this one process (they export the same ``PyInit__fastcodec`` symbol
under different spec names).  On the same payloads (golden fixtures,
seeded random sessions, the value-type zoo) the parsed columns must be
equal field for field, the encoded bytes identical, both equal to the
pure-Python codec, and every rejection the same error class.  Skips
visibly where ``g++`` is missing.
"""
import json
import math
import shutil
from pathlib import Path

import numpy as np
import pytest

from crdt_graph_tpu import native as jnative
from crdt_graph_tpu.codec import json_codec as jjson
from crdt_graph_tpu.codec import packed as jpacked

from crdt_graph_tpu_torch import native as tnative
from crdt_graph_tpu_torch.codec import json_codec as tjson
from crdt_graph_tpu_torch.codec import packed as tpacked
from crdt_graph_tpu_torch.core import operation as top
from crdt_graph_tpu_torch.core.operation import Add, Delete

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++: the native codec cannot "
                                       "build here")


@pytest.fixture(scope="module", autouse=True)
def both_codecs_loaded():
    """Both builds, loaded once per test process.  The reference's
    loader compiles straight into its package directory, so a test
    process that raced another one's first build retries it once."""
    if not jnative.available():
        jnative.load(rebuild=True)
    assert jnative.available(), jnative._build_error
    assert tnative.available(), tnative._build_error


COLS = ("kind", "ts", "parent_ts", "anchor_ts", "depth", "paths",
        "value_ref", "pos", "parent_pos", "anchor_pos", "target_pos",
        "ts_rank")

GOLDEN = [
    '{"op":"add","path":[0,1],"ts":2,"val":"a"}',
    '{"op":"del","path":[1,2,3]}',
    '{"op":"batch","ops":[{"op":"add","path":[0],"ts":1,"val":"x"},'
    '{"op":"del","path":[1]}]}',
    '{"op":"batch","ops":[{"op":"batch","ops":['
    '{"op":"add","path":[0],"ts":1,"val":1}]},'
    '{"op":"add","path":[1],"ts":2,"val":2},{"op":"batch","ops":[]}]}',
    '{"op":"mystery","path":[1]}',
    '{"op":null}',
    '{"op":"batch","ops":[{"op":"future","x":[{"y":1}]},'
    '{"op":"add","path":[0],"ts":5,"val":null}]}',
    '  {  "op" : "add" , "path" : [ 0 , 1 ] , "ts" : 2 , '
    '"val" : { "a" : [ 1 , 2 ] } }  ',
    '{"op":"add","path":[0],"ts":1,"ts":2,"val":"x","val":"y"}',
    '{"op":"add","path":[0],"ts":1,"val":[Infinity,-Infinity]}',
    '{"op":"add","path":[0],"ts":1,"val":"\\ud800\\udc00x"}',
    json.dumps({"op": "add", "path": [0], "ts": (2**30 - 1) * 2**32 + 7,
                "val": "\U0001F680 ß"}),
]

BAD = [
    '{"op":"add","path":[0]}',
    '{"op":"add","ts":1,"val":1}',
    '{"op":"add","path":[0],"ts":1.5,"val":1}',
    '{"op":"add","path":[0.5],"ts":1,"val":1}',
    '{"op":"add","path":[0],"ts":true,"val":1}',
    '{"op":"del"}',
    '{"op":"batch"}',
    '{"op":"batch","ops":{}}',
    '{"path":[0],"ts":1,"val":1}',
    '{"op":"add","path":[0],"ts":4611686018427387905,"val":1}',
    'noise',
    '{"op":"add","path":[0],"ts":1,"val":1} trailing',
    '{"op":"del","path":[01]}',
    '{"op":"add","path":[0],"ts":1,"val":1.}',
    '{"op":"add","path":[0],"ts":1,"val":.5}',
    '{"op":"add","path":[0],"ts":1,"val":1.0e}',
    '{"op":"add","path":[0],"ts":01,"val":1}',
]


def random_session(seed, n=300, n_replicas=3):
    """A seeded session of adds (random anchors and value types) and
    deletes, as the port's op objects; values include every JSON type
    the wire carries."""
    rng = np.random.default_rng(seed)
    ops, alive, clocks = [], [0], [0] * n_replicas
    for _ in range(n):
        if len(alive) > 2 and rng.random() < 0.2:
            ops.append(Delete((int(alive[rng.integers(1, len(alive))]),)))
            continue
        r = int(rng.integers(0, n_replicas))
        clocks[r] += 1
        ts = (r + 1) * 2**32 + clocks[r]
        kind = int(rng.integers(0, 6))
        val = [f"v{ts}", float(rng.integers(-9, 9)) / 4, None,
               {"n": int(ts), "l": [1, "x"]}, bool(kind % 2),
               int(rng.integers(-2**40, 2**40))][kind]
        ops.append(Add(ts, (int(alive[rng.integers(0, len(alive))]),), val))
        alive.append(ts)
    return ops


def assert_columns_equal(got, want, what):
    assert got.num_ops == want.num_ops, what
    assert got.hints_vouched == want.hints_vouched, what
    for f in COLS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, (what, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {f}")
    assert repr(got.values) == repr(want.values), what


def test_both_extensions_load_in_one_process():
    assert tnative.available(), tnative._build_error
    assert jnative.available()
    tmod, jmod = tnative.load(), jnative.load()
    assert tmod is not jmod
    assert tmod.__name__ == "crdt_graph_tpu_torch.native._fastcodec"
    assert jmod.__name__ == "crdt_graph_tpu.native._fastcodec"
    so = tnative.so_path()
    assert tnative.BUILD_ROOT in so.parents
    assert Path(jnative.__file__).parent not in so.parents
    # both answer in the same process
    p = '{"op":"add","path":[0],"ts":1,"val":"x"}'
    assert tmod.parse_pack(p.encode(), 4)["n"] == \
        jmod.parse_pack(p.encode(), 4)["n"] == 1


@pytest.mark.parametrize("payload", GOLDEN, ids=range(len(GOLDEN)))
def test_golden_fixtures_parse_equal(payload):
    got = tnative.parse_pack(payload, max_depth=16)
    want = jnative.parse_pack(payload, max_depth=16)
    assert_columns_equal(got, want, "native vs reference native")
    py = tpacked.pack(tjson.loads(payload), max_depth=16)
    for f in ("kind", "ts", "parent_ts", "anchor_ts", "depth", "paths",
              "value_ref", "pos", "parent_pos", "anchor_pos",
              "target_pos"):
        np.testing.assert_array_equal(getattr(got, f), getattr(py, f), f)
    if got.num_ops:
        assert tnative.encode_pack(got) == jnative.encode_pack(want)


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_random_sessions_parse_and_encode_identical(seed):
    ops = random_session(seed)
    payload = tjson.dumps(top.from_list(ops))
    assert payload == jjson.dumps(jjson.loads(payload))
    got = tnative.parse_pack(payload, max_depth=8)
    want = jnative.parse_pack(payload, max_depth=8)
    assert_columns_equal(got, want, f"seed {seed}")
    # the egress direction, from the Python packer's columns
    p_t = tpacked.pack(ops, max_depth=8)
    p_j = jpacked.pack(jjson.loads(payload), max_depth=8)
    enc = tnative.encode_pack(p_t)
    assert enc == jnative.encode_pack(p_j)
    assert enc.decode() == payload
    for start in (1, len(ops) // 2, len(ops) - 1):
        assert tnative.encode_pack(p_t, start) == \
            jnative.encode_pack(p_j, start)


def test_value_payload_types_encode_identical():
    vals = ["str", "", "unié中😀", 0, -5, 2**40, 2**80, -2**90, 1.5,
            -0.25, -0.0, 1e10, 1e-12, float("inf"), float("-inf"),
            float("nan"), True, False, None, [1, [2, "x"], (3, 4)],
            {"k": {"n": None, "l": [1.0]}, "é": "☃"},
            {1: "a", 2.5: "b", True: "c", None: "d"},
            "esc\"\\\n\t/control\x01\x1f"]
    ops = [Add(i + 1, (i,), v) for i, v in enumerate(vals)]
    p_t = tpacked.pack(ops, max_depth=4)
    got = tnative.encode_pack(p_t)
    want = tjson.dumps(top.from_list(ops)).encode()
    assert got == want
    p_j = jpacked.pack(jjson.loads(want.decode()), max_depth=4)
    # the reference parses NaN back as a new float object: compare reprs
    assert repr(json.loads(jnative.encode_pack(p_j))) == \
        repr(json.loads(got))
    assert math.isnan(tnative.parse_pack(got).values[15])


@pytest.mark.parametrize("bad", BAD, ids=range(len(BAD)))
def test_rejections_raise_the_same_class(bad):
    with pytest.raises(Exception) as et:
        tnative.parse_pack(bad)
    with pytest.raises(Exception) as ej:
        jnative.parse_pack(bad)
    assert et.type is ej.type is ValueError
    with pytest.raises(ValueError):
        tpacked.pack(tjson.loads(bad))


def test_deep_nesting_rejected_not_segfault():
    deep = "[" * 100_000 + "]" * 100_000
    doc = '{"op":"add","path":[0],"ts":1,"val":' + deep + "}"
    with pytest.raises(ValueError, match="nesting too deep"):
        tnative.parse_pack(doc)


def test_unencodable_value_falls_back_to_python():
    class Opaque:
        pass
    p = tpacked.pack([Add(1, (0,), Opaque())])
    with pytest.raises(ValueError):
        tnative.encode_pack(p)


def test_calls_are_counted():
    tnative.reset_calls()
    p = tnative.parse_pack(GOLDEN[2])
    tnative.encode_pack(p)
    tpacked.pack_json(GOLDEN[0])
    assert tnative.calls == {"parse_pack": 2, "encode_pack": 1}


def test_engine_wire_paths_take_the_native_codec():
    """``apply_wire`` parses natively, ``dumps_since_bytes`` encodes
    natively, and both equal the reference engine's bytes."""
    from crdt_graph_tpu import engine as jengine
    from crdt_graph_tpu_torch import engine as tengine
    ops = random_session(40, n=1500, n_replicas=2)
    ops = [op for op in ops if isinstance(op, Add)]
    payload = tjson.dumps(top.from_list(ops))
    tnative.reset_calls()
    t = tengine.init(0, device="cpu")
    t.apply_wire(payload.encode())
    assert tnative.calls["parse_pack"] == 1
    j = jengine.init(0)
    j.apply_wire(payload.encode())
    assert t.visible_values() == j.visible_values()
    for since in (0, ops[700].ts, ops[-1].ts, 12345):
        assert t.dumps_since_bytes(since) == j.dumps_since_bytes(since)
    assert tnative.calls["encode_pack"] >= 3
