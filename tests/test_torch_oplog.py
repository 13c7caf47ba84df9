"""The port's op log against the reference's, on the CPU.

The same operations (the reference's objects, carried to the port's
through the wire JSON) and the same packed segments go into
``crdt_graph_tpu.oplog.OpLog`` and ``crdt_graph_tpu_torch.oplog.OpLog``;
iteration, lengths, ``index_of_add``, truncation, column export,
``operations_since`` suffixes and the bounded anti-entropy windows must
agree exactly (wire bytes compared byte for byte).  The engine-level
cases of the reference's op-log suite (columnar bulk ingest, partial
absorb, rejection, the checkpoint span, the restore audit) run on the
port's engine with ``device="cpu"``.
"""
import io
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from crdt_graph_tpu import oplog as joplog  # noqa: E402
from crdt_graph_tpu import engine as jengine  # noqa: E402
from crdt_graph_tpu.codec import json_codec as jjson  # noqa: E402
from crdt_graph_tpu.codec import packed as jpacked  # noqa: E402
from crdt_graph_tpu.core import operation as jop  # noqa: E402
from crdt_graph_tpu.core.operation import Add as JAdd  # noqa: E402
from crdt_graph_tpu.core.operation import Delete as JDelete  # noqa: E402

from crdt_graph_tpu_torch import engine as tengine  # noqa: E402
from crdt_graph_tpu_torch import oplog as toplog  # noqa: E402
from crdt_graph_tpu_torch.codec import json_codec as tjson  # noqa: E402
from crdt_graph_tpu_torch.codec import packed as tpacked  # noqa: E402
from crdt_graph_tpu_torch.core import operation as top  # noqa: E402
from crdt_graph_tpu_torch.core.errors import OperationFailedError  # noqa

COLS = ("kind", "ts", "parent_ts", "anchor_ts", "depth", "paths",
        "value_ref", "pos", "parent_pos", "anchor_pos", "target_pos",
        "ts_rank")


def ts(r, c):
    return r * 2**32 + c


def chain_ops(r, n, start=1):
    """n adds by replica r (the reference's objects), each anchored on
    the previous; start > 1 continues the chain across batches."""
    out = []
    prev = ts(r, start - 1) if start > 1 else 0
    for c in range(start, start + n):
        out.append(JAdd(ts(r, c), (prev,), f"v{r}.{c}"))
        prev = ts(r, c)
    return out


def port(ops):
    """The reference's op objects → the port's, through the wire JSON."""
    return list(tjson.loads(jjson.dumps(jop.from_list(list(ops)))).ops) \
        if len(ops) != 1 else [tjson.loads(jjson.dumps(ops[0]))]


def wire(ops, pkg):
    mod = jjson if pkg == "jax" else tjson
    opm = jop if pkg == "jax" else top
    return mod.dumps(opm.from_list(list(ops)))


class Logs:
    """One reference log and one port log fed the same segments."""

    def __init__(self, ops=()):
        self.j = joplog.OpLog(ops)
        self.t = toplog.OpLog(port(ops) if ops else ())

    def extend(self, ops):
        self.j.extend(ops)
        self.t.extend(port(ops))

    def extend_packed(self, ops, max_depth=4, start=0, stop=None):
        self.j.extend_packed(jpacked.pack(ops, max_depth=max_depth),
                             start, stop)
        self.t.extend_packed(tpacked.pack(port(ops), max_depth=max_depth),
                             start, stop)

    def truncate(self, n):
        self.j.truncate(n)
        self.t.truncate(n)

    def check(self):
        assert len(self.j) == len(self.t)
        assert bool(self.j) == bool(self.t)
        assert self.j.num_segments == self.t.num_segments
        assert wire(list(self.j), "jax") == wire(list(self.t), "torch")
        assert self.j.view()._starts.tolist() == \
            self.t.view()._starts.tolist()
        assert self.j.view().last_add_pos == self.t.view().last_add_pos
        jb, tb = self.j.as_batch(), self.t.as_batch()
        assert type(jb).__name__ == type(tb).__name__
        assert jjson.dumps(jb) == tjson.dumps(tb)


def _segments(logs):
    logs.extend(chain_ops(1, 5))
    logs.extend_packed(chain_ops(2, 7))
    logs.extend([JDelete((ts(1, 5),))])
    logs.extend_packed(chain_ops(1, 6, start=6), start=1, stop=5)
    logs.extend(chain_ops(3, 3) + [JDelete((ts(3, 3),))])
    return logs


def test_mixed_segments_iterate_in_order():
    logs = _segments(Logs())
    logs.check()
    n = len(logs.t)
    for i in (0, 5, 12, n - 1, -1, -3):
        assert jjson.dumps(logs.j[i]) == tjson.dumps(logs.t[i])
    for a, b in ((3, 9), (0, n), (11, 14), (5, 5)):
        assert wire(logs.j[a:b], "jax") == wire(logs.t[a:b], "torch")
        assert wire(logs.j.materialize(a, b), "jax") == \
            wire(logs.t.materialize(a, b), "torch")
    for bad in (slice(None, None, 2), slice(None, None, -1)):
        with pytest.raises(ValueError):
            logs.t[bad]
    with pytest.raises(IndexError):
        logs.t[n]


@pytest.mark.parametrize("cut", [0, 3, 5, 6, 9, 13, 14, 17, 100])
def test_truncate_matches(cut):
    logs = _segments(Logs())
    logs.truncate(cut)
    logs.check()
    logs.extend([JDelete((ts(1, 1),))])
    logs.extend_packed(chain_ops(4, 3))
    logs.check()


def test_index_of_add_spans_segments():
    logs = _segments(Logs())
    probes = [ts(1, c) for c in range(1, 12)] + \
        [ts(2, c) for c in range(0, 9)] + [ts(3, 3), ts(9, 9), 0]
    for t in probes:
        assert logs.j.index_of_add(t) == logs.t.index_of_add(t), t


def test_index_of_add_over_an_unindexed_packed_segment():
    """A packed segment with no cached timestamp index (one read back
    from disk, or a union, has none) builds it on the first query: the
    same positions as the reference's, as Python ints."""
    ops = chain_ops(2, 7) + chain_ops(4, 5) + [JDelete((ts(2, 3),))]
    j = joplog.OpLog(chain_ops(1, 3))
    j.extend_packed(jpacked.pack(ops, max_depth=4))
    t = toplog.OpLog(port(chain_ops(1, 3)))
    p = tpacked.pack(port(ops), max_depth=4)
    p.ts_index = None
    t.extend_packed(p)
    probes = [ts(2, c) for c in range(0, 9)] + \
        [ts(4, c) for c in range(1, 7)] + [ts(1, 2), 0, ts(9, 9), 2**70]
    for s in probes:
        got = t.index_of_add(s)
        assert got == j.index_of_add(s), s
        assert got is None or type(got) is int
    assert t.index_of_add(ts(4, 5)) == 3 + 7 + 4


def test_packed_since_off_a_packing_with_its_index_handed_over():
    """``pack`` hands its packing a ready index: suffixes and windows off
    it, from every mark and an unknown one, match the reference's."""
    _, mixed = _window_log()
    jp = jpacked.pack(mixed, max_depth=4)
    tp = tpacked.pack(port(mixed), max_depth=4)
    assert isinstance(tp.ts_index, tpacked.TsIndex)
    for since in [0] + [op.ts for op in mixed] + [ts(5, 5)]:
        assert jengine.packed_since_bytes(jp, since) == \
            tengine.packed_since_bytes(tp, since), since
        for limit in (0, 3):
            assert jengine.packed_since_window(jp, since, limit) == \
                tengine.packed_since_window(tp, since, limit), since


def test_to_packed_matches():
    logs = _segments(Logs())
    a = logs.j.to_packed(max_depth=4)
    b = logs.t.to_packed(max_depth=4)
    assert a.num_ops == b.num_ops
    for k in COLS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)
    assert a.values == b.values
    assert a.hints_vouched == b.hints_vouched
    assert tpacked.verify_hints(b)


def test_view_is_reference_stable_across_truncate():
    logs = _segments(Logs())
    jv, tv = logs.j.view(), logs.t.view()
    logs.truncate(4)
    logs.extend(chain_ops(5, 2))
    assert wire(list(jv.iter_ops()), "jax") == \
        wire(list(tv.iter_ops()), "torch")
    assert jv.length == tv.length == 21


def _window_log():
    logs = Logs()
    ops = chain_ops(1, 9) + chain_ops(2, 9)
    mixed = [op for pair in zip(ops[:9], ops[9:]) for op in pair]
    logs.extend(mixed[:6])
    logs.extend_packed(mixed[6:14])
    logs.extend(mixed[14:] + [JDelete((ts(1, 9),)), JDelete((ts(2, 2),))])
    return logs, mixed


def test_since_bytes_and_windows_match_at_every_boundary():
    """Suffixes and chained bounded windows over a multi-segment view:
    byte- and meta-identical to the reference's, at every Add boundary
    and for an unknown mark."""
    logs, mixed = _window_log()
    jv, tv = logs.j.view(), logs.t.view()
    marks = [0] + [op.ts for op in mixed] + [ts(5, 5)]
    for since in marks:
        assert jv.since_bytes(since) == tv.since_bytes(since), since
        for limit in (0, 1, 3, 4, 7, 100):
            jw_, jm = jv.window(since, limit)
            tw_, tm = tv.window(since, limit)
            assert jw_ == tw_, (since, limit)
            assert jm == tm, (since, limit)
    assert tv.window_plan(0, 4) == (None, [])


def test_packed_since_window_matches_reference():
    """The engine's windows straight off one packing, chained: the same
    bytes and meta as the reference's, reassembling the suffix."""
    logs, mixed = _window_log()
    jp = logs.j.to_packed(max_depth=4)
    tp = logs.t.to_packed(max_depth=4)
    for since in [0] + [op.ts for op in mixed] + [ts(5, 5)]:
        assert jengine.packed_since_bytes(jp, since) == \
            tengine.packed_since_bytes(tp, since)
        for limit in (0, 2, 4, 5):
            s_j = s_t = since
            for _ in range(40):
                bj, mj = jengine.packed_since_window(jp, s_j, limit)
                bt, mt = tengine.packed_since_window(tp, s_t, limit)
                assert bj == bt and mj == mt, (since, limit)
                if mj["next_since"] is not None:
                    s_j = s_t = mj["next_since"]
                if not mj["more"]:
                    break


def test_packed_batch_is_lazy_and_counts():
    p = tpacked.pack(port(chain_ops(3, 8)), max_depth=4)
    pb = toplog.PackedBatch(p)
    assert top.count(pb) == 8
    assert pb._ops is None, "count must not materialize"
    plain = top.Batch(tuple(tpacked.unpack(p)))
    assert pb == plain and plain == pb
    assert tjson.dumps(pb) == jjson.dumps(
        joplog.PackedBatch(jpacked.pack(chain_ops(3, 8), max_depth=4)))


def test_tail_is_and_tiering_refused(tmp_path, monkeypatch):
    """``tail_is`` identity, and tiering (once refused) now arms: the
    same appends spill to segment files byte-identical to the
    reference's, and the tiered log reads back the same rows.  The zip
    members' timestamps are the only wall-clock bytes of a segment
    file; the zip clock is frozen so whole files compare."""
    import time
    import types
    import zipfile
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: 1_700_000_000.0, localtime=time.localtime))
    t = toplog.OpLog()
    p = tpacked.pack(port(chain_ops(1, 4)), max_depth=4)
    t.extend_packed(p)
    assert t.tail_is(toplog.PackedBatch(p))
    assert not t.tail_is(toplog.PackedBatch(
        tpacked.pack(port(chain_ops(1, 4)), max_depth=4)))
    assert not t.tiering_enabled
    logs = {}
    for name, mod, ops in (("t", toplog, port(chain_ops(2, 40))),
                           ("j", joplog, chain_ops(2, 40))):
        lg = mod.OpLog()
        lg.enable_tiering(str(tmp_path / name), hot_ops=8, max_depth=4,
                          auto_stable=False)
        assert lg.tiering_enabled
        for k in range(0, 40, 10):
            lg.extend(ops[k:k + 10])
            lg.maybe_spill()
        logs[name] = lg
    segs = sorted(f.name for f in (tmp_path / "t").iterdir())
    assert segs and segs == sorted(f.name for f in
                                   (tmp_path / "j").iterdir())
    for f in segs:
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f
    assert logs["t"].telemetry()["spills"] >= 1
    assert [tjson.dumps(o) for o in logs["t"]] == \
        [jjson.dumps(o) for o in logs["j"]]


# -- the engine-level cases (port engine on the CPU) ---------------------

def _tree():
    return tengine.init(0, device="cpu")


def test_bulk_ingest_stays_columnar():
    t = _tree()
    t.apply_packed(tpacked.pack(port(chain_ops(1, 2000)), max_depth=4))
    assert isinstance(t.last_operation, toplog.PackedBatch)
    assert t.last_operation._ops is None
    assert top.count(t.last_operation) == 2000
    assert not isinstance(t._log._segs[-1], list)
    suffix = t.operations_since(ts(1, 1999))
    assert [op.ts for op in suffix.ops] == [ts(1, 1999), ts(1, 2000)]
    assert t.operations_since(ts(7, 1)) == top.Batch(())


def test_bulk_ingest_partial_absorb_columnar():
    ops = port(chain_ops(1, 1500))
    new = port(chain_ops(1, 1100, start=1501))
    t = _tree()
    t.apply_packed(tpacked.pack(ops, max_depth=4))
    t.apply_packed(tpacked.pack(ops[-1100:] + new, max_depth=4))
    assert t.log_length == 2600
    assert top.count(t.last_operation) == 1100
    assert int(t.last_applied_mask.sum()) == 1100
    obj = _tree()
    obj.apply(top.from_list(ops + new))
    assert t.visible_values() == obj.visible_values()
    assert t._replicas == obj._replicas


def test_bulk_reject_reports_first_failing_op():
    t = _tree()
    t.apply_packed(tpacked.pack(port(chain_ops(1, 1200)), max_depth=4))
    bad = port(chain_ops(2, 1100) + [JAdd(ts(3, 1), (ts(9, 9),), "orphan")])
    with pytest.raises(OperationFailedError) as e:
        t.apply_packed(tpacked.pack(bad, max_depth=4))
    assert e.value.operation == bad[-1]
    assert t.log_length == 1200


def test_checkpoint_span_roundtrip_columnar():
    t = _tree()
    t.apply_packed(tpacked.pack(port(chain_ops(1, 1500)), max_depth=4))
    buf = io.BytesIO()
    t.checkpoint_packed(buf, compress=False)
    buf.seek(0)
    meta = json.loads(bytes(np.load(buf)["meta"]).decode())
    assert meta["last_op_span"] == [0, 1500]
    assert "last_operation" not in meta
    buf.seek(0)
    r = tengine.TpuTree.restore_packed(buf, device="cpu")
    assert r.log_length == 1500
    assert isinstance(r.last_operation, toplog.PackedBatch)
    assert r.visible_values() == t.visible_values()
    assert list(r._log) == list(t._log)


def test_corrupt_hint_checkpoint_is_rebuilt(monkeypatch):
    """A vouched checkpoint with corrupt hints is repaired at restore,
    before any merge, with the vouch tripwire unset."""
    monkeypatch.delenv("GRAFT_DEBUG_VOUCH", raising=False)
    t = _tree()
    t.apply_packed(tpacked.pack(port(chain_ops(1, 1500)), max_depth=4))
    buf = io.BytesIO()
    t.checkpoint_packed(buf, compress=False)
    buf.seek(0)
    z = np.load(buf)
    cols = {k: z[k].copy() for k in z.files}
    n = len(cols["kind"])
    cols["anchor_pos"][:] = 0
    cols["parent_pos"][:] = 0
    cols["ts_rank"][:n // 2] = np.arange(n // 2, dtype=np.int32)[::-1]
    evil = io.BytesIO()
    np.savez(evil, **cols)
    evil.seek(0)
    r = tengine.TpuTree.restore_packed(evil, device="cpu")
    assert r._packed.hints_vouched
    assert tpacked.verify_hints(r._packed)
    more = port(chain_ops(2, 1100))
    r.apply_packed(tpacked.pack(more, max_depth=4))
    obj = _tree()
    obj.apply(top.from_list(port(chain_ops(1, 1500)) + more))
    assert r.visible_values() == obj.visible_values()
