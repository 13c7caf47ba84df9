"""The port's replica engine against the reference's, on the CPU.

Every session runs on ``crdt_graph_tpu.engine.TpuTree`` and on
``crdt_graph_tpu_torch.engine.TpuTree(device="cpu")`` side by side: the
same operations (carried through the wire JSON), the same local edits.
After every step the two replicas must agree on ``visible_values``,
``visible_paths``, ``timestamp``, ``cursor``, ``log_length``,
``last_applied_mask``, ``last_operation``, ``operations_since`` at 0 and
at the newest add as wire JSON, ``dumps_since``, ``len`` and the node
views (``get``/``parent``/``next``/``prev`` and ``walk`` over every
visible path).  The node table (every field) is compared after each bulk
step and at the end of each session: each table read is one merge, and
the reference compiles one trace per log-size bucket.
"""
import io
import json
import random

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

torch.set_num_threads(1)

import crdt_graph_tpu as crdt  # noqa: E402
from crdt_graph_tpu import engine as jengine  # noqa: E402
from crdt_graph_tpu.codec import json_codec as jjson  # noqa: E402
from crdt_graph_tpu.codec import packed as jpacked  # noqa: E402
from crdt_graph_tpu.core import operation as jop  # noqa: E402

import crdt_graph_tpu_torch as tcrdt  # noqa: E402
from crdt_graph_tpu_torch import convert  # noqa: E402
from crdt_graph_tpu_torch import engine as tengine  # noqa: E402
from crdt_graph_tpu_torch.codec import json_codec as tjson  # noqa: E402
from crdt_graph_tpu_torch.codec import packed as tpacked  # noqa: E402
from crdt_graph_tpu_torch.core import operation as top  # noqa: E402
from crdt_graph_tpu_torch.ops import merge as tmerge  # noqa: E402

OFF = 2**32


def to_port(op):
    """A reference operation → the port's, through the wire JSON."""
    return tjson.loads(jjson.dumps(op))


def _paths(t):
    return [tuple(p) for p in t.visible_paths()]


def _views(t):
    """Every node-view answer over the visible paths, as plain data."""
    out = []
    for p in _paths(t) + [(0,), (12345,)]:
        n = t.get(p)
        if n is None:
            out.append((p, None))
            continue
        par, nx, pv = t.parent(n), t.next(n), t.prev(n)
        out.append((p, n.value, n.timestamp, n.is_deleted,
                    par.path if par is not None else None,
                    nx.path if nx is not None else None,
                    pv.path if pv is not None else None,
                    [c.path for c in n.children()]))
    walked = t.walk(lambda n, acc: ("take", acc + [n.path]), [])
    r = t.root()
    combos = (r.map(lambda n: n.value),
              r.foldl(lambda n, acc: acc + [n.timestamp], []),
              r.foldr(lambda n, acc: acc + [n.timestamp], []),
              r.filter_map(lambda n: n.value if n.timestamp % 2 else None),
              r.loop(lambda n, acc: ("done" if len(acc) > 2 else "take",
                                     acc + [n.path]), []),
              [(x.path if x is not None else None) for x in
               (r.head(), r.last(), r.find(lambda n: n.timestamp % 3 == 0))])
    desc = [(x.path if x is not None else None) for x in
            (r.descendant(p) for p in _paths(t)[:6] + [(4242,)])]
    return out, walked, combos, desc


def _errors(fn):
    try:
        fn()
        return None
    except (crdt.CRDTError, tcrdt.CRDTError) as e:
        return type(e).__name__


class Pair:
    """A reference replica and a port replica driven in lockstep."""

    def __init__(self, rid, j=None, t=None):
        self.j = j if j is not None else jengine.init(rid)
        self.t = t if t is not None else tengine.init(rid, device="cpu")

    # -- driving ----------------------------------------------------------

    def apply(self, op):
        ej = _errors(lambda: self.j.apply(op))
        et = _errors(lambda: self.t.apply(to_port(op)))
        assert ej == et, (ej, et)
        return ej

    def apply_wire(self, payload):
        ej = _errors(lambda: self.j.apply_wire(payload))
        et = _errors(lambda: self.t.apply_wire(payload))
        assert ej == et, (ej, et)
        return ej

    def local(self, name, *args):
        """One local edit by method name (the same on both engines)."""
        ej = _errors(lambda: getattr(self.j, name)(*args))
        et = _errors(lambda: getattr(self.t, name)(*args))
        assert ej == et, (name, args, ej, et)
        return ej

    def packed(self, ops, chunk=None):
        jp = jpacked.pack(ops)
        tp = tpacked.pack([to_port(o) for o in ops])
        if chunk is None:
            ej = _errors(lambda: self.j.apply_packed(jp))
            et = _errors(lambda: self.t.apply_packed(tp))
        else:
            ej = _errors(lambda: self.j.apply_packed_chunked(jp, chunk))
            et = _errors(lambda: self.t.apply_packed_chunked(tp, chunk))
        assert ej == et, (ej, et)
        return ej

    # -- checking ---------------------------------------------------------

    def check(self, table=False):
        j, t = self.j, self.t
        assert t.visible_values() == j.visible_values()
        assert _paths(t) == _paths(j)
        assert (t.timestamp, t.cursor, t.log_length, len(t)) == \
            (j.timestamp, j.cursor, j.log_length, len(j))
        mj, mt = j.last_applied_mask, t.last_applied_mask
        assert (mj is None) == (mt is None)
        if mj is not None:
            np.testing.assert_array_equal(mt, mj)
        assert tjson.dumps(t.last_operation) == jjson.dumps(j.last_operation)
        since = [0]
        log = jop.to_list(j.operations_since(0))
        adds = [op.ts for op in log if isinstance(op, crdt.Add)]
        if adds:
            since += [adds[-1], adds[len(adds) // 2], 77 * OFF + 1]
        for s in since:
            assert tjson.dumps(t.operations_since(s)) == \
                jjson.dumps(j.operations_since(s)), s
            assert t.dumps_since(s) == j.dumps_since(s), s
        assert _views(t) == _views(j)
        for r in {op.ts >> 32 for op in log if isinstance(op, crdt.Add)}:
            assert t.last_replica_timestamp(r) == \
                j.last_replica_timestamp(r)
        if table:
            self.check_table()

    def check_table(self):
        jt, tt = self.j.table(), self.t.table()
        for f in tmerge.FIELDS:
            want = np.asarray(getattr(jt, f))
            got = np.asarray(getattr(tt, f))
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)


def chain(r, n, start=1, anchor=None):
    """n adds by replica r, each anchored on the previous."""
    prev = anchor if anchor is not None else \
        (r * OFF + start - 1 if start > 1 else 0)
    out = []
    for c in range(start, start + n):
        out.append(crdt.Add(r * OFF + c, (prev,), f"{r}.{c}"))
        prev = r * OFF + c
    return out


def test_engine_requires_a_device_or_an_explicit_cpu():
    """Without a card and without ``device=``, the port refuses: it never
    runs a bulk merge on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    for make in (lambda: tengine.init(1), lambda: tengine.TpuTree(1),
                 lambda: tcrdt.init(1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert tengine.init(1, device="cpu").device == torch.device("cpu")


def test_local_edits_and_batch_rollback():
    """Local edits (add, branch, delete, cursor moves) and atomic
    batches, including a batch whose failing func rolls it back."""
    p = Pair(3)
    p.check()
    for v in "abc":
        p.local("add", v)
        p.check()
    p.local("add_branch", "B")
    p.local("add", "b1")
    p.local("add", "b2")
    p.check()
    p.local("move_cursor_up")
    p.local("add", "d")
    p.check()
    paths = _paths(p.j)
    p.local("delete", paths[1])
    p.check()
    p.local("delete", paths[1])                # twice: absorbed
    p.local("delete", (0,))                    # the sentinel
    p.local("set_cursor", paths[0])
    p.check()
    assert p.local("set_cursor", (999,)) == "NotFound"
    p.local("batch", [lambda t: t.add("x"), lambda t: t.add("y"),
                      lambda t: t])
    p.check()

    def bad(t):
        raise crdt.OperationFailedError(crdt.Add(1, (0,), "z"))

    assert p.local("batch", [lambda t: t.add("q"), bad]) == \
        "OperationFailedError"
    p.check()
    p.local("delete", _paths(p.j)[0])
    p.local("delete", (404,))                  # missing target
    p.check(table=True)


def test_two_replicas_exchange_over_wire():
    a, b = Pair(1), Pair(2)
    rng = random.Random(0)
    marks = {1: 0, 2: 0}
    for step in range(40):
        src, dst, rid = (a, b, 1) if step % 2 == 0 else (b, a, 2)
        for _ in range(rng.randrange(1, 4)):
            roll = rng.random()
            if roll < 0.6:
                src.local("add", f"{rid}:{step}")
            elif roll < 0.75:
                src.local("add_branch", f"{rid}:{step}b")
            elif _paths(src.j):
                src.local("delete", rng.choice(_paths(src.j)))
        payload = src.j.dumps_since(marks[rid])
        assert payload == src.t.dumps_since(marks[rid])
        dst.apply_wire(payload)
        marks[rid] = src.j.timestamp
        src.check()
        dst.check()
    a.apply_wire(b.j.dumps_since(0))
    b.apply_wire(a.j.dumps_since(0))
    assert a.t.visible_values() == b.t.visible_values()
    a.check(table=True)
    b.check(table=True)


def _bulk_ops():
    """1,000 causally ordered adds over 4 replicas and a few branches."""
    ops = chain(5, 300) + chain(6, 300, anchor=5 * OFF + 150)
    br = 7 * OFF + 1
    ops += [crdt.Add(br, (0,), "branch")]
    ops += chain(7, 200, start=2, anchor=0)
    ops = [crdt.Add(o.ts, (br,) + o.path, o.value) if (o.ts >> 32) == 7
           and o.ts != br else o for o in ops]
    ops += chain(8, 199, anchor=6 * OFF + 10)
    return ops


@pytest.mark.parametrize("shuffled", [False, True])
def test_bulk_delta_host_first_and_set_join(shuffled):
    """A 1,000-leaf delta: in causal order it applies host-first through
    the mirror; shuffled, the sequential apply fails and the bulk merge's
    set-join absorbs it.  Then a 1,200-leaf delta (past the crossover)
    takes the bulk merge directly."""
    p = Pair(9)
    p.local("add", "seed")
    ops = _bulk_ops()
    assert len(ops) == 1000
    if shuffled:
        random.Random(1).shuffle(ops)
    p.apply(crdt.Batch(tuple(ops)))
    p.check(table=True)
    more = chain(10, 1200)
    if shuffled:
        random.Random(2).shuffle(more)
    p.apply(crdt.Batch(tuple(more)))
    p.check(table=True)


@pytest.mark.parametrize("big", [False, True])
def test_failing_batch_leaves_replica_untouched(big):
    p = Pair(4)
    p.apply(crdt.Batch(tuple(chain(1, 40))))
    p.check()
    n = 1100 if big else 20
    bad = chain(2, n) + [crdt.Add(3 * OFF + 1, (9 * OFF + 9,), "orphan")]
    assert p.apply(crdt.Batch(tuple(bad))) == "OperationFailedError"
    p.check()
    bad = chain(2, n) + [crdt.Delete((2 * OFF + 5, 77))]
    assert p.apply(crdt.Batch(tuple(bad))) is not None
    p.check(table=big)


def test_duplicate_redelivery_absorbed():
    p = Pair(5)
    ops = chain(1, 300) + chain(2, 50, anchor=1 * OFF + 7)
    p.apply(crdt.Batch(tuple(ops)))
    p.check()
    p.apply(crdt.Batch(tuple(ops)))            # whole redelivery
    p.check()
    p.apply(ops[3])                             # one op again
    p.apply(crdt.Batch(tuple(ops[-5:] + chain(3, 4))))   # overlap + new
    p.check(table=True)


def test_apply_packed_chunked_equals_single_shot():
    ops = chain(1, 1500) + chain(2, 900, anchor=1 * OFF + 20)
    single, chunked = Pair(7), Pair(7)
    single.packed(ops)
    chunked.packed(ops, chunk=512)
    single.check()
    chunked.check()
    assert chunked.t.visible_values() == single.t.visible_values()
    assert chunked.t.log_length == single.t.log_length
    np.testing.assert_array_equal(chunked.t.last_applied_mask,
                                  single.t.last_applied_mask)
    # a chunk that fails on its own but not as a set: rolled back and
    # retried single-shot, identically in both packages
    late = Pair(7)
    rev = chain(3, 1200)
    late.packed(rev[600:] + rev[:600], chunk=512)
    late.check(table=True)


def test_json_checkpoint_round_trip(tmp_path):
    p = Pair(6)
    p.apply(crdt.Batch(tuple(chain(1, 30))))
    p.local("add", "mine")
    p.local("delete", _paths(p.j)[3])
    p.j.checkpoint(str(tmp_path / "j.json"))
    p.t.checkpoint(str(tmp_path / "t.json"))
    assert json.loads((tmp_path / "j.json").read_text()) == \
        json.loads((tmp_path / "t.json").read_text())
    r = Pair(0, j=jengine.TpuTree.restore(str(tmp_path / "t.json")),
             t=tengine.TpuTree.restore(str(tmp_path / "j.json"),
                                       device="cpu"))
    r.check()
    r.local("add", "after")
    r.check()


def _bulk_pair(rid=8):
    p = Pair(rid)
    p.packed(chain(1, 1500) + chain(2, 600, anchor=1 * OFF + 3))
    p.local("add", "tail")
    p.local("delete", (1 * OFF + 8,))
    return p


def test_checkpoint_packed_restores_across_packages():
    """Each package restores the other's binary checkpoint to an equal
    replica: the same file format, field for field."""
    p = _bulk_pair()
    p.check()
    bj, bt = io.BytesIO(), io.BytesIO()
    p.j.checkpoint_packed(bj, compress=False)
    p.t.checkpoint_packed(bt, compress=False)
    zj, zt = np.load(io.BytesIO(bj.getvalue())), \
        np.load(io.BytesIO(bt.getvalue()))
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        np.testing.assert_array_equal(zj[k], zt[k], err_msg=k)
    cross = Pair(0, j=jengine.TpuTree.restore_packed(io.BytesIO(
        bt.getvalue())), t=tengine.TpuTree.restore_packed(
            io.BytesIO(bj.getvalue()), device="cpu"))
    cross.check(table=True)
    assert convert.replica_state_to_numpy(cross.t).keys() == \
        convert.replica_state_to_numpy(cross.j).keys()
    sj = convert.replica_state_to_numpy(cross.j)
    st = convert.replica_state_to_numpy(cross.t)
    for k, v in sj.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(st[k], v, err_msg=k)
            assert st[k].dtype == v.dtype, k
        else:
            assert st[k] == v, k
    renamed = Pair(0, j=jengine.TpuTree.restore_packed(
        io.BytesIO(bt.getvalue()), replica=21),
        t=tengine.TpuTree.restore_packed(io.BytesIO(bj.getvalue()),
                                         replica=21, device="cpu"))
    renamed.local("add", "new id")
    renamed.check()


def test_hintless_checkpoint_first_read_takes_the_join():
    """An older-format checkpoint (no hint columns, no vouch): the first
    read's merge runs the verified auto mode, whose link check fails on
    the defaulted hints, so it falls back to the sort+join once — and
    reads the same replica as the reference."""
    p = _bulk_pair()
    buf = io.BytesIO()
    p.j.checkpoint_packed(buf, compress=False)
    z = np.load(io.BytesIO(buf.getvalue()))
    meta = json.loads(bytes(z["meta"]).decode())
    meta.pop("hints_vouched")
    old = {k: z[k] for k in z.files
           if k not in ("parent_pos", "anchor_pos", "target_pos",
                        "ts_rank", "meta")}
    old["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    out = io.BytesIO()
    np.savez(out, **old)
    r = Pair(0, j=jengine.TpuTree.restore_packed(io.BytesIO(out.getvalue())),
             t=tengine.TpuTree.restore_packed(io.BytesIO(out.getvalue()),
                                              device="cpu"))
    assert not r.t.packed_state().hints_vouched
    tmerge.fallbacks = 0
    r.check(table=True)
    assert tmerge.fallbacks == 1
    assert r.t.visible_values() == p.t.visible_values()


@pytest.mark.parametrize("seed", [13, 0, 7])
def test_to_oracle_and_random_lockstep(seed):
    """A random session of remote applies and local edits, in lockstep
    on both engines and the oracle (the reference's
    test_random_session_engine_oracle_lockstep)."""
    rng = random.Random(seed)
    p = Pair(2)
    oracle = crdt.init(2)
    remote = [chain(r, 60) for r in (3, 4)]
    for step in range(120):
        roll = rng.random()
        if roll < 0.35 and remote[step % 2]:
            op = remote[step % 2].pop(0)
            p.apply(op)
            oracle = oracle.apply(op)
        elif roll < 0.7:
            v = rng.randrange(1000)
            p.local("add", v)
            oracle = oracle.add(v)
        elif roll < 0.8:
            p.local("add_branch", step)
            oracle = oracle.add_branch(step)
        elif roll < 0.9 and _paths(p.j):
            path = rng.choice(_paths(p.j))
            p.local("delete", path)
            oracle = oracle.delete(path)
        else:
            p.local("move_cursor_up")
            oracle = oracle.move_cursor_up()
        if step % 10 == 0:
            p.check()
        assert p.t.visible_values() == oracle.visible_values()
        assert p.t.cursor == oracle.cursor
        assert p.t.timestamp == oracle.timestamp
    p.check(table=True)
    ot, oj = p.t.to_oracle(), p.j.to_oracle()
    assert isinstance(ot, tcrdt.CRDTree)
    assert ot.visible_values() == oj.visible_values()
    assert (ot.timestamp, ot.cursor) == (oj.timestamp, oj.cursor)
    assert tjson.dumps(ot.operations_since(0)) == \
        jjson.dumps(oj.operations_since(0))


def test_reorder_semantics_match():
    """Small batches: sequence semantics (a non-causal order fails like
    the reference); large batches: set semantics for adds, while a
    delete placed before its add still fails."""
    R = 5 * OFF
    nested = [crdt.Add(R + 1, (0,), "branch"),
              crdt.Add(R + 2, (R + 1, 0), "child"),
              crdt.Add(R + 3, (R + 1,), "sibling"),
              crdt.Delete((R + 1, R + 2)),
              crdt.Add(R + 4, (R + 3, 0), "grandchild")]
    import itertools
    for perm in itertools.islice(itertools.permutations(nested), 0, 120, 7):
        p = Pair(1)
        p.apply(crdt.Batch(tuple(perm)))
        p.check()
    big = chain(2, 400)
    p = Pair(1)
    p.apply(crdt.Batch(tuple(reversed(big))))
    p.check()
    p = Pair(1)
    bad = [crdt.Delete((2 * OFF + 400,))] + big
    assert p.apply(crdt.Batch(tuple(bad))) is not None
    p.check()


def test_stale_views_fail_after_a_bulk_merge(tmp_path):
    """Views go stale across a bulk merge; and the tiering entry points
    (once refused) now work: the log tiers, spills at the next commit,
    checkpoints, and the checkpoint restores to the same replica."""
    t = tengine.init(1, device="cpu")
    t.add("a")
    n = t.get(t.visible_paths()[0])
    t.apply(top.from_list([to_port(o) for o in chain(4, 1100)]))
    with pytest.raises(tengine.StaleNodeView):
        n.value
    assert t.get((1 * OFF + 1,)).value == "a"
    assert t.enable_log_tiering(str(tmp_path / "tiers"), hot_ops=64) is t
    t.add("b")
    assert t._log.spills >= 1
    path = t.checkpoint_tiered(str(tmp_path / "tiers"))
    assert path.endswith("manifest.json")
    r = tengine.TpuTree.restore_tiered(str(tmp_path / "tiers"),
                                       device="cpu")
    assert r.visible_values() == t.visible_values()
    assert r.matz_stats["loads"] == 1
    assert (r.timestamp, r.cursor, r.log_length) == \
        (t.timestamp, t.cursor, t.log_length)


@pytest.mark.parametrize("count", [tengine.DELTA_THRESHOLD,
                                   tengine.DELTA_THRESHOLD + 1])
def test_threshold_boundary_equal(count):
    """Exactly DELTA_THRESHOLD and one more leaves: different paths, the
    same replica."""
    p = Pair(1)
    p.apply(crdt.Batch(tuple(chain(3, count))))
    p.check()
    assert p.t.visible_values() == [f"3.{i}" for i in range(1, count + 1)]


def test_interleaved_host_and_bulk_applies():
    """Host-path edits between bulk merges: views, clocks and the log
    stay in step with the reference across every switch of path."""
    p = Pair(2)
    p.local("add", "x")
    p.apply(crdt.Batch(tuple(chain(5, 1100))))
    p.check()
    p.local("add", "y")
    p.apply(chain(6, 1)[0])
    p.apply(crdt.Batch(tuple(chain(6, 1200, start=2))))
    p.local("delete", (5 * OFF + 10,))
    p.check(table=True)


def test_sentinel_paths_match():
    """Branch-head sentinel paths: ``get`` answers under the root and
    live nodes, ``set_cursor`` accepts them, deleting one is absorbed."""
    p = Pair(3)
    p.local("add", "a")
    p.local("add_branch", "b")
    p.local("add", "c")
    b = _paths(p.j)[1]
    for path in [(0,), b + (0,), (77, 0), _paths(p.j)[0] + (0,)]:
        gj, gt = p.j.get(path), p.t.get(path)
        assert (gj is None) == (gt is None), path
        if gj is not None:
            assert (gt.path, gt.is_deleted, gt.value) == \
                (gj.path, gj.is_deleted, gj.value)
    p.local("set_cursor", b + (0,))
    p.local("add", "under b")
    p.local("delete", b + (0,))
    p.local("delete", (88, 0))
    p.check()


def test_views_survive_host_edits_and_go_stale_together():
    p = Pair(4)
    p.apply(crdt.Batch(tuple(chain(1, 20))))
    nj, nt = p.j.get((1 * OFF + 5,)), p.t.get((1 * OFF + 5,))
    p.local("add_after", (1 * OFF + 5,), "new")
    p.local("delete", (1 * OFF + 6,))
    assert (nt.value, nt.path, nt.is_deleted) == \
        (nj.value, nj.path, nj.is_deleted)
    assert [c.path for c in (p.t.next(nt), p.t.prev(nt))] == \
        [c.path for c in (p.j.next(nj), p.j.prev(nj))]
    p.apply(crdt.Batch(tuple(chain(2, 1100))))
    with pytest.raises(jengine.StaleNodeView):
        nj.value
    with pytest.raises(tengine.StaleNodeView):
        nt.value
    p.check()


@pytest.mark.parametrize("cut", ["truncated", "bad_meta", "bad_rows"])
def test_corrupt_checkpoint_is_a_typed_error(cut):
    p = _bulk_pair()
    buf = io.BytesIO()
    p.t.checkpoint_packed(buf, compress=False)
    raw = buf.getvalue()
    if cut == "truncated":
        data = raw[:len(raw) // 2]
    else:
        z = np.load(io.BytesIO(raw))
        cols = {k: z[k] for k in z.files}
        meta = json.loads(bytes(cols["meta"]).decode())
        if cut == "bad_meta":
            meta["num_ops"] = True
        else:
            meta["last_op_span"] = [0, 10**9]
        cols["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
        o = io.BytesIO()
        np.savez(o, **cols)
        data = o.getvalue()
    with pytest.raises(crdt.CheckpointError):
        jengine.TpuTree.restore_packed(io.BytesIO(data))
    with pytest.raises(tcrdt.CheckpointError):
        tengine.TpuTree.restore_packed(io.BytesIO(data), device="cpu")
