"""The nested outline document (``gen/nested.py``) and the merge tier
driver: the generator repeats from a seed and keeps its causal shape,
the plain reference reads a depth-8 document as the port's persistent
state machine (``core/tree.CRDTree``, the upstream's rules) does, and
one remote step of the tiny cell matches the reference while the
control does not."""
import numpy as np
import pytest

from crdtbench import control, kernelwork
from crdtbench.drivers import mergetier
from crdtbench.gen import OFFSET, nested, rng_for
from crdtbench.reference import check, rga
from crdtbench.tests.conftest import TINY

CELL = "nested8x8.solo"
SEEDS = (0, 2**31 + 5, -7)


def _same(a, b):
    return all(np.array_equal(a[k], b[k]) for k in a)


def _doc(seed, base=1500, delta=640, replicas=8, depth=8):
    b, _ = nested.nested_rows(rng_for(seed, 1), replicas, depth,
                              np.zeros(replicas, np.int64), base)
    d, _ = nested.nested_rows(rng_for(seed, 2), replicas, depth,
                              nested.counters_after(b, replicas), delta)
    return b, d


def _cat(a, b):
    return {k: np.concatenate([a[k], b[k]]) for k in a}


@pytest.mark.parametrize("seed", SEEDS)
def test_nested_rows_repeat_from_seed(seed):
    a, va = nested.nested_rows(rng_for(seed, 1), 8, 8, np.zeros(8), 700)
    b, vb = nested.nested_rows(rng_for(seed, 1), 8, 8, np.zeros(8), 700)
    assert _same(a, b) and va == vb
    c, _ = nested.nested_rows(rng_for(seed + 1, 1), 8, 8, np.zeros(8), 700)
    assert c["paths"].shape == a["paths"].shape == (700, 8)
    assert not np.array_equal(c["ts"], a["ts"])


def test_every_depth_and_causal_order():
    base, delta = _doc(4, base=4000, delta=2560)
    assert set(np.unique(base["depth"])) == set(range(1, 9))
    assert set(np.unique(delta["depth"])) == set(range(1, 9))
    # the skeleton: replica 1's first 7 ops, branch k at depth k
    assert np.array_equal(base["ts"][:7], OFFSET + np.arange(1, 8))
    assert np.array_equal(base["depth"][:7], np.arange(1, 8))
    cols = _cat(base, delta)
    row = {int(t): i for i, t in enumerate(cols["ts"])}
    assert len(row) == cols["ts"].size           # every timestamp fresh
    for i in range(cols["ts"].size):
        d = int(cols["depth"][i])
        path = cols["paths"][i]
        assert np.all(path[d:] == 0)
        assert cols["anchor_ts"][i] == path[d - 1]
        assert cols["parent_ts"][i] == (path[d - 2] if d > 1 else 0)
        for ref in (cols["anchor_ts"][i], cols["parent_ts"][i]):
            assert ref == 0 or row[int(ref)] < i
    # the link hints point at the row they name, inside the batch
    for part in (base, delta):
        for hint, ref in (("anchor_pos", "anchor_ts"),
                          ("parent_pos", "parent_ts")):
            h = part[hint]
            inside = h >= 0
            assert np.all(h[inside] < np.nonzero(inside)[0])
            assert np.array_equal(part["ts"][h[inside]], part[ref][inside])


def test_a_delta_continues_the_counters():
    base, delta = _doc(4)
    before = nested.counters_after(base, 8)
    after = nested.counters_after(_cat(base, delta), 8)
    assert before.sum() == 1500 and after.sum() == 2140
    rid = delta["ts"] // OFFSET
    for r in range(1, 9):
        got = np.sort(delta["ts"][rid == r] % OFFSET)
        assert np.array_equal(got, np.arange(before[r - 1] + 1,
                                             after[r - 1] + 1))
    # the same branches: every delta path prefix is a skeleton path
    skel = nested.branch_paths(8)
    for i in range(delta["ts"].size):
        d = int(delta["depth"][i])
        assert np.array_equal(delta["paths"][i, :d - 1], skel[d - 1, :d - 1])


def test_reference_reads_the_depth8_document_as_the_state_machine():
    from crdt_graph_tpu_torch.core.operation import Add
    from crdt_graph_tpu_torch.core.tree import TAKE, CRDTree
    base, delta = _doc(7, base=300, delta=192)
    cols = _cat(base, delta)
    n = cols["ts"].size
    want = rga.converge(cols["kind"], cols["ts"], cols["depth"],
                        cols["paths"], n)
    assert np.all(want["status"] == rga.APPLIED)
    assert want["order_depth"].max() == 8
    # the state machine, fed the ops in another causal order: the
    # skeleton first, then replica by replica
    rid = cols["ts"] // OFFSET
    order = np.r_[np.arange(7), 7 + np.lexsort((cols["ts"][7:], rid[7:]))]
    tree = CRDTree.init(99)
    for i in order:
        d = int(cols["depth"][i])
        tree = tree.apply(Add(int(cols["ts"][i]),
                              tuple(int(x) for x in cols["paths"][i, :d]),
                              int(i)))
    paths = []
    tree.walk(lambda node, acc: (TAKE, acc.append(node.path) or acc), paths)
    assert np.array_equal([p[-1] for p in paths], want["order_ts"])
    assert np.array_equal([len(p) for p in paths], want["order_depth"])
    assert np.array_equal([p[-2] if len(p) > 1 else 0 for p in paths],
                          want["order_parent_ts"])


def test_a_remote_step_matches_the_reference_and_the_control_does_not(
        root):
    cfg = {"replicas": 8, "depth": 8, "local_replica": 9}
    tr = {}
    TINY[CELL](cfg, tr)
    drv = mergetier.Driver(cfg, tr, 11, "cpu", False)
    drv.setup()
    k = int(np.argmax(tr["delta_ops"]))
    _, table = drv.step(drv.delta_p[k])
    cols = drv.candidates(k)
    n = cols["ts"].size
    got = check.table_view(*(np.asarray(getattr(table, f)) for f in (
        "ts", "visible_order", "num_visible", "depth", "parent",
        "status")), n)
    assert check.judge(got, cols, n) == {f: 0 for f in check.LIMITS}
    assert drv.client.stats()["fallbacks"] == {}
    assert drv.worker.stats()["batch_width"]["count"] >= 2   # warm + step
    # the epoch launches the hand kernels in their batched forms only
    with kernelwork.Capture() as c:
        drv.step(drv.delta_p[k])
    assert c.bound_ms > 0 and c.calls
    assert all(f.endswith(kernelwork.BATCHED) for f in c.calls)
    drv.worker.close()
    got = control.readings(CELL, 11, root=root, adjust=TINY[CELL])
    assert got["answers"] == tr["checked_steps"]
    assert got["order_mismatches"] > 0
