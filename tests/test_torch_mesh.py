"""The port's docs-axis batching (``parallel.mesh``) against the
reference's, on the CPU.

The same per-document op lists are packed by each package's own codec;
``stack_packed`` / ``stack_aligned`` must give bit-identical columns, and
the port's ``batched_materialize(device="cpu")`` must equal the
reference's ``batched_materialize`` (a ``docs`` mesh of B devices on the
conftest's 8-device CPU platform, as ``tests/test_parallel.py`` builds
it) in every ``NodeTable`` field at B = 1, 2 and 4.  The batches mix
capacity buckets and depth buckets, and one document carries deletes.
Each document's slice of the batched table must equal that document's
own single port merge.  ``LingerBatcher`` is held to its width cap, its
linger window and its error fan-out.
"""
import random
import threading
import time

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

torch.set_num_threads(1)

import crdt_graph_tpu as crdt  # noqa: E402
from crdt_graph_tpu.codec import json_codec as jjson  # noqa: E402
from crdt_graph_tpu.codec import packed as jpacked  # noqa: E402
from crdt_graph_tpu.core import operation as jop  # noqa: E402
from crdt_graph_tpu.ops import view as jview  # noqa: E402
from crdt_graph_tpu.parallel import mesh as jmesh  # noqa: E402

from crdt_graph_tpu_torch import convert  # noqa: E402
from crdt_graph_tpu_torch.codec import json_codec as tjson  # noqa: E402
from crdt_graph_tpu_torch.codec import packed as tpacked  # noqa: E402
from crdt_graph_tpu_torch.core import operation as top  # noqa: E402
from crdt_graph_tpu_torch.ops import merge as tmerge  # noqa: E402
from crdt_graph_tpu_torch.parallel import mesh as tmesh  # noqa: E402

OFF = 2**32


def _session(seed, steps, n_replicas=3, branch=0.15, delete=0.15):
    """A merged multi-replica oracle session's op list (reference
    objects): adds, branches (depth > 1) and, with ``delete`` > 0,
    deletes."""
    rng = random.Random(seed)
    trees = [crdt.init(r + 1) for r in range(n_replicas)]
    for _ in range(steps):
        i = rng.randrange(n_replicas)
        t = trees[i]
        roll = rng.random()
        try:
            if roll < branch:
                t = t.add_branch(rng.randrange(1000))
            elif roll < branch + delete:
                vis = []
                t.walk(lambda n, acc: (crdt.TAKE,
                                       acc.append(n.path) or acc), vis)
                if vis:
                    t = t.delete(rng.choice(vis))
            elif roll < 0.85:
                t = t.add(rng.randrange(1000))
            else:
                j = rng.randrange(n_replicas)
                if j != i:
                    t = t.apply(trees[j].operations_since(0))
        except crdt.CRDTError:
            pass
        trees[i] = t
    for i in range(n_replicas):
        for j in range(n_replicas):
            if i != j:
                trees[i] = trees[i].apply(trees[j].operations_since(0))
    return jop.to_list(trees[0].operations_since(0))


def _chain(rid, n):
    ops, prev = [], 0
    for i in range(n):
        ts = rid * OFF + i + 1
        ops.append(crdt.Add(ts, (prev,), i & 0xFF))
        prev = ts
    return ops


# four documents: a flat chain (small bucket, depth 1), a session with
# deletes and branches, a deeper branchy session without deletes, and a
# longer chain in a larger capacity bucket
_DOC_OPS = [
    _chain(5, 37),
    _session(1, 90),
    _session(2, 70, branch=0.45, delete=0.0),
    _chain(6, 140),
]


def _pack_both(ops):
    """Pack the same ops with each package's codec (the port's get them
    through the wire JSON)."""
    port_ops = top.to_list(tjson.loads(jjson.dumps(jop.from_list(ops))))
    return jpacked.pack(ops), tpacked.pack(port_ops)


_PACKED = [_pack_both(ops) for ops in _DOC_OPS]
_BATCHES = {1: [1], 2: [0, 2], 4: [0, 1, 2, 3]}
_JAX_BATCHED = {}


def _docs(b):
    idx = _BATCHES[b]
    return [_PACKED[i][0] for i in idx], [_PACKED[i][1] for i in idx]


def _reference_batched(b, exhaustive=False):
    """The reference's batched table for batch ``b`` (host numpy), traced
    once per batch and mode."""
    key = (b, exhaustive)
    if key not in _JAX_BATCHED:
        jdocs, _ = _docs(b)
        stacked, _ = jmesh.stack_aligned(jdocs)
        m = jmesh.make_mesh(n_docs=b, n_ops=1)
        _JAX_BATCHED[key] = jview.to_host(jmesh.batched_materialize(
            stacked, m, exhaustive_hints=exhaustive))
    return _JAX_BATCHED[key]


def _assert_arrays_equal(ja, ta):
    assert sorted(ja) == sorted(ta)
    for k in ja:
        assert ja[k].dtype == ta[k].dtype, k
        np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)


def _assert_table_equal(jt, tt, tag=""):
    got = convert.table_to_numpy(tt)
    for f in tmerge.FIELDS:
        want = getattr(jt, f)
        want = want.numpy() if isinstance(want, torch.Tensor) \
            else np.asarray(want)
        assert got[f].dtype == want.dtype, f"{tag} {f} dtype"
        np.testing.assert_array_equal(got[f], want, err_msg=f"{tag} {f}")


def test_batches_mix_buckets_depths_and_deletes():
    caps = {p.capacity for _, p in _PACKED}
    depths = {p.max_depth for _, p in _PACKED}
    assert len(caps) >= 2 and len(depths) >= 2
    kinds = np.concatenate([p.kind[:p.num_ops] for _, p in _PACKED[1:2]])
    assert np.any(kinds == tpacked.KIND_DELETE)


@pytest.mark.parametrize("b", [1, 2, 4])
def test_stack_packed_and_aligned_bit_identical(b):
    """The port stacks each document's columns, which are the
    reference's stack less the slot hints the port's merge derives on
    its device: the same arrays, bit for bit."""
    jdocs, tdocs = _docs(b)

    def columns(stacked):
        assert set(stacked) - set(tdocs[0].columns()) <= \
            set(tpacked.SLOT_HINT_COLS + tpacked.CROWD_HINT_COLS)
        return {k: stacked[k] for k in tdocs[0].columns()}

    ts = tmesh.stack_packed(tdocs)
    assert set(ts) == set(tdocs[0].columns())
    _assert_arrays_equal(columns(jmesh.stack_packed(jdocs)), ts)
    (js, jal), (ts, tal) = jmesh.stack_aligned(jdocs), \
        tmesh.stack_aligned(tdocs)
    _assert_arrays_equal(columns(js), ts)
    for jp, tp in zip(jal, tal):
        assert jp.capacity == tp.capacity == max(p.capacity for p in tdocs)
        _assert_arrays_equal(jp.arrays(), tp.arrays())


@pytest.mark.parametrize("b", [1, 2, 4])
def test_batched_materialize_equals_reference(b):
    _, tdocs = _docs(b)
    stacked, _ = tmesh.stack_aligned(tdocs)
    btab = tmesh.batched_materialize(stacked, device="cpu")
    assert btab.status.shape[0] == b
    _assert_table_equal(_reference_batched(b), btab, f"B={b}")


@pytest.mark.parametrize("b", [1, 2, 4])
def test_doc_slices_equal_single_merges(b):
    """Each document's slice of the batched table is its own single
    merge of its capacity-aligned columns; a narrower document's path
    plane is the single merge's, widened with zeros."""
    _, tdocs = _docs(b)
    stacked, aligned = tmesh.stack_aligned(tdocs)
    btab = tmesh.batched_materialize(stacked, device="cpu")
    for i, p in enumerate(aligned):
        got = convert.table_to_numpy(tmesh.doc_table(btab, i))
        want = convert.table_to_numpy(
            tmerge.materialize(p.arrays(), device="cpu"))
        for f in tmerge.FIELDS:
            g = got[f]
            if f == "paths":
                w = want[f].shape[1]
                assert not g[:, w:].any(), f"doc {i} widened paths"
                g = g[:, :w]
            assert g.dtype == want[f].dtype, f
            np.testing.assert_array_equal(g, want[f],
                                          err_msg=f"doc {i} {f}")


@pytest.mark.parametrize("b", [1, 2, 4])
def test_materialize_each_equals_batched_slices(b):
    """The per-document tables the serving scheduler commits from are
    the batched table's slices, each at the shared capacity."""
    _, tdocs = _docs(b)
    stacked, aligned = tmesh.stack_aligned(tdocs)
    btab = tmesh.batched_materialize(stacked, device="cpu")
    tables = tmesh.materialize_each(stacked, device="cpu")
    assert len(tables) == b
    for i, t in enumerate(tables):
        assert t.status.shape[0] == aligned[i].capacity
        _assert_table_equal(tmesh.doc_table(btab, i), t, f"doc {i}")


def test_exhaustive_hints_leg_equals_reference_and_join():
    _, tdocs = _docs(4)
    stacked, _ = tmesh.stack_aligned(tdocs)
    # the slot hints are the merge's to derive, in one [B, N] call
    assert "ts_rank" in stacked and not set(tmerge.SLOT_HINTS) & set(stacked)
    fast = tmesh.batched_materialize(stacked, device="cpu",
                                     exhaustive_hints=True)
    _assert_table_equal(_reference_batched(4, exhaustive=True), fast,
                        "exhaustive")
    safe = tmesh.batched_materialize(stacked, device="cpu")
    _assert_table_equal(safe, fast, "exhaustive vs join")


def test_batched_join_body_drops_position_hints(monkeypatch):
    """The default body runs the join leg without the position hints,
    as the reference's batched body does; the exhaustive body keeps
    them.  Either way the batch is ONE merge of its ``[B, N]`` columns."""
    seen = []
    real = tmerge._materialize

    def spy(ops, hints, dev, no_deletes, *a, **kw):
        seen.append((hints, tmerge.select_leg(ops, hints),
                     any(k in ops for k in tmesh.POS_HINTS),
                     tuple(ops["kind"].shape)))
        return real(ops, hints, dev, no_deletes, *a, **kw)

    monkeypatch.setattr(tmerge, "_materialize", spy)
    _, tdocs = _docs(2)
    stacked, _ = tmesh.stack_aligned(tdocs)
    shape = tuple(stacked["kind"].shape)
    tmesh.batched_materialize(stacked, device="cpu")
    assert seen == [("join", "join", False, shape)]
    seen.clear()
    tmesh.batched_materialize(stacked, device="cpu", exhaustive_hints=True)
    assert [s[0] for s in seen] == ["exhaustive"]
    assert all(s[2] and s[3] == shape for s in seen)


def test_batched_materialize_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    _, tdocs = _docs(1)
    stacked, _ = tmesh.stack_aligned(tdocs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.batched_materialize(stacked)


# -- LingerBatcher ---------------------------------------------------------


def _riders(batcher, items):
    boxes = [{} for _ in items]

    def go(item, box):
        try:
            box["result"] = batcher.submit(item)
        except BaseException as e:   # noqa: BLE001 — test capture
            box["error"] = e

    threads = [threading.Thread(target=go, args=(it, bx), daemon=True)
               for it, bx in zip(items, boxes)]
    return threads, boxes


def test_linger_batcher_width_cap_launches_early():
    launches = []
    b = tmesh.LingerBatcher(lambda items: launches.append(list(items))
                            or [x * 10 for x in items],
                            linger_s=20.0, max_width=3)
    threads, boxes = _riders(b, [1, 2, 3])
    t0 = time.monotonic()
    for th in threads:
        th.start()
        time.sleep(0.02)
    for th in threads:
        th.join(10)
        assert not th.is_alive()
    assert time.monotonic() - t0 < 10       # the 20 s window was cut
    assert launches == [[1, 2, 3]]
    assert sorted(bx["result"] for bx in boxes) == [10, 20, 30]
    st = b.stats()
    assert st["launches"] == 1 and st["full_launches"] == 1
    assert st["items_in"] == 3 and st["pending"] == 0
    b.close()


def test_linger_batcher_window_gathers_then_launches():
    launches = []
    b = tmesh.LingerBatcher(lambda items: launches.append(list(items))
                            or [x + 1 for x in items],
                            linger_s=0.3, max_width=16)
    threads, boxes = _riders(b, [5, 6])
    t0 = time.monotonic()
    threads[0].start()
    time.sleep(0.05)
    threads[1].start()
    for th in threads:
        th.join(10)
        assert not th.is_alive()
    assert time.monotonic() - t0 >= 0.25    # the leader lingered
    assert launches == [[5, 6]]
    assert [bx["result"] for bx in boxes] == [6, 7]
    st = b.stats()
    assert st["linger_waits"] == 1 and st["full_launches"] == 0
    # a later lone submit is its own epoch
    assert b.submit(9) == 10
    assert b.stats()["launches"] == 2
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(1)


def test_linger_batcher_error_reaches_every_rider():
    boom = ValueError("launch failed")

    def launch(items):
        raise boom

    b = tmesh.LingerBatcher(launch, linger_s=5.0, max_width=4)
    threads, boxes = _riders(b, [1, 2, 3, 4])
    for th in threads:
        th.start()
    for th in threads:
        th.join(10)
        assert not th.is_alive()
    assert all(bx.get("error") is boom for bx in boxes)
    assert b.stats()["launches"] == 1
    b.close()
