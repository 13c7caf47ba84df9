"""The docs-axis batched merge (``ops.merge`` on ``[B, N]`` columns, the
reference's vmapped ``batched_materialize``) and the batched forms of
kernels 1-4, on the CPU.

Adversarial batches (documents deliberately unlike each other: 4 to 512
replicas, deletes in some documents only, a rejected anchor cycle and an
unresolved reference, a single-group document beside one crowded past
``S_CAP2``, run counts on both sides of ``R_CAP``, capacities padded by
``stack_aligned``) go through the port's ``batched_materialize`` and the
reference's, on both legs, at B = 1, 3 and 8: every document's slice is
bit-identical to the reference's batched table and to the port's own
single merge.  The compact widths are scaled (as the audit tests scale
them) so the tiers fall inside these small shapes.  The batched kernels'
twins equal their per-document single twins on wild indices; the audit
counts a batch as one merge; extra loop rounds and wider tiers change no
document's table; a batch too large for one merge is cut into
sub-batches by the fixed row rule.
"""
import random

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
from crdt_graph_tpu_torch.ops import fused_resolve as tfr  # noqa: E402
from crdt_graph_tpu_torch.ops import merge as tmerge  # noqa: E402
from crdt_graph_tpu_torch.ops import mono_gather as tmg  # noqa: E402
from crdt_graph_tpu_torch.ops import tour_scan as tts  # noqa: E402
from crdt_graph_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from crdt_graph_tpu_torch.utils import chainaudit  # noqa: E402

OFF = 2**32
# the compact widths, scaled so both sides of each tier fall inside
# these documents (S_CAP2 16 crowded rows, R_CAP 256 runs)
CAPS = {"GRAFT_S_CAP": "256", "GRAFT_S_CAP2": "16",
        "GRAFT_R_CAP": "256", "GRAFT_R_CAP2": "64"}


@pytest.fixture(autouse=True)
def scaled_caps(monkeypatch):
    for k, v in CAPS.items():
        monkeypatch.setenv(k, v)


def _chains(n_replicas, n, seed=0):
    """``n`` adds over ``n_replicas`` interleaved flat chains (each
    replica's adds anchored at its previous one, the first at the root's
    sentinel)."""
    rng = random.Random(seed)
    prev = {}
    ops = []
    for i in range(n):
        r = rng.randrange(n_replicas) + 1
        ts = r * OFF + i + 1
        ops.append(crdt.Add(ts, (prev.get(r, 0),), i & 0xFF))
        prev[r] = ts
    return ops


def _session(seed, steps, n_replicas=3, branch=0.15, delete=0.15):
    """A merged multi-replica oracle session's op list."""
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


def _hostile():
    """A chain with an anchor cycle (two adds anchored at each other:
    rejected) and an add anchored at a timestamp no op has (unresolved)."""
    ops = _chains(2, 40, seed=3)
    a, b = 90 * OFF + 1, 90 * OFF + 2
    ops += [crdt.Add(a, (b,), 1), crdt.Add(b, (a,), 2),
            crdt.Add(91 * OFF + 5, (77 * OFF + 9,), 3)]
    return ops


# eight documents, unlike each other:
_DOC_OPS = [
    _chains(4, 300, seed=1),                      # 4 replicas
    _chains(512, 700, seed=2),                    # 512: crowded, many runs
    _session(1, 90),                              # deletes and branches
    _session(2, 70, branch=0.45, delete=0.0),     # branchy, no deletes
    _hostile(),                                   # cycle + unresolved
    [crdt.Add(5 * OFF + i + 1, (0,), i) for i in range(40)],  # one group
    _chains(1, 600, seed=4),                      # one chain: few runs
    _chains(8, 12, seed=5),                       # tiny: padded capacity
]
_BATCHES = {1: [4], 3: [0, 2, 5], 8: list(range(8))}


def _pack_both(ops):
    port_ops = top.to_list(tjson.loads(jjson.dumps(jop.from_list(ops))))
    return jpacked.pack(ops), tpacked.pack(port_ops)


_PACKED = [_pack_both(ops) for ops in _DOC_OPS]
_JAX = {}


def _docs(b):
    idx = _BATCHES[b]
    return [_PACKED[i][0] for i in idx], [_PACKED[i][1] for i in idx]


def _reference(b, exhaustive):
    key = (b, exhaustive)
    if key not in _JAX:
        jdocs, _ = _docs(b)
        stacked, _ = jmesh.stack_aligned(jdocs)
        m = jmesh.make_mesh(n_docs=b, n_ops=1)
        _JAX[key] = jview.to_host(jmesh.batched_materialize(
            stacked, m, exhaustive_hints=exhaustive))
    return _JAX[key]


def _np(t):
    return convert.table_to_numpy(t)


def _assert_fields_equal(got, want, tag):
    for f in tmerge.FIELDS:
        g, w = got[f], np.asarray(want[f])
        assert g.dtype == w.dtype, f"{tag} {f} dtype"
        np.testing.assert_array_equal(g, w, err_msg=f"{tag} {f}")


def test_batches_are_adversarial():
    """The documents differ as the module docstring says."""
    kinds = [p.kind[:p.num_ops] for _, p in _PACKED]
    assert [bool(np.any(k == tpacked.KIND_DELETE)) for k in kinds][:4] == \
        [False, False, True, False]
    assert len({p.capacity for _, p in _PACKED}) >= 3
    t = tmerge.materialize(_PACKED[4][1].arrays(), hints="join",
                           device="cpu")
    st = t.status.numpy()[:_PACKED[4][1].num_ops]
    assert (st[-3:] != tmerge.APPLIED).all()      # cycle + unresolved


@pytest.mark.parametrize("exhaustive", [False, True],
                         ids=["join", "exhaustive"])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_batched_equals_reference_and_single_merges(b, exhaustive):
    _, tdocs = _docs(b)
    stacked, aligned = tmesh.stack_aligned(tdocs)
    btab = tmesh.batched_materialize(stacked, device="cpu",
                                     exhaustive_hints=exhaustive)
    assert btab.status.shape[0] == b
    got = _np(btab)
    _assert_fields_equal(got, {f: getattr(_reference(b, exhaustive), f)
                               for f in tmerge.FIELDS}, f"B={b}")
    for i, p in enumerate(aligned):
        one = _np(tmerge.materialize(p.arrays(), hints="join",
                                     device="cpu"))
        for f in tmerge.FIELDS:
            g = got[f][i]
            if f == "paths":
                w = one[f].shape[1]
                assert not g[:, w:].any(), f"doc {i} widened paths"
                g = g[:, :w]
            assert g.dtype == one[f].dtype, f
            np.testing.assert_array_equal(g, one[f], err_msg=f"doc {i} {f}")


def test_materialize_each_is_views_of_one_table():
    _, tdocs = _docs(3)
    stacked, _ = tmesh.stack_aligned(tdocs)
    tables = tmesh.materialize_each(stacked, device="cpu")
    assert len(tables) == 3
    base = {t.ts.untyped_storage().data_ptr() for t in tables}
    assert len(base) == 1
    btab = tmesh.batched_materialize(stacked, device="cpu")
    for i, t in enumerate(tables):
        _assert_fields_equal(_np(t), _np(tmesh.doc_table(btab, i)),
                             f"doc {i}")


# -- the batched kernels' twins ------------------------------------------

def _wild(rng, shape, r):
    x = rng.integers(-2 * r, 2 * r, shape).astype(np.int32)
    x[..., :6] = [-1, -r, -r - 5, r, 2**31 - 1, -2**31]
    return torch.from_numpy(x)


@pytest.mark.parametrize("b", [1, 3])
def test_batched_plane_rows_twins_equal_single_twins(b):
    rng = np.random.default_rng(b)
    r, c, t = 50, 5, 77
    plane = torch.from_numpy(rng.integers(-60, 60, (b, r, c)))
    idx = _wild(rng, (b, t), r)
    out = tfr.plain_rows_batched(plane, idx)
    g, g2 = tfr.plain_rows2_batched(plane, idx, 2)
    assert out.shape == (b, t, c)
    for i in range(b):
        assert torch.equal(out[i], tfr.plain_rows(plane[i], idx[i]))
        w, w2 = tfr.plain_rows2(plane[i], idx[i], 2)
        assert torch.equal(g[i], w) and torch.equal(g2[i], w2)
    # hops below zero zero the row; past R clamp to the document's last
    hop = g[..., 2]
    assert (hop < 0).any() and (hop >= r).any()
    assert (g2[hop < 0] == 0).all()
    # the wrappers run the twins on CPU tensors
    assert torch.equal(tfr.plane_rows_batched(plane, idx), out)
    for x, y in zip(tfr.plane_rows2_batched(plane, idx, 2), (g, g2)):
        assert torch.equal(x, y)


def test_batched_prefix_sums_restart_at_each_document():
    """int32 wrap inside a document, and no carry across the boundary:
    document 0's lanes end near the int32 top, document 1 restarts."""
    rng = np.random.default_rng(7)
    t, kw, m = 9000, 2, 4100
    bnd = torch.from_numpy(rng.integers(0, 2, (2, t)).astype(np.int32))
    w = torch.from_numpy(rng.integers(0, 3, (2, kw, m)).astype(np.int32))
    bnd[0, :] = 2**31 - 7
    w[0, 1, :] = 2**30
    ob, ow = tts.prefix_sums_batched(bnd, w)
    for i in range(2):
        a, bw = tts.plain_prefix(bnd[i], w[i])
        assert torch.equal(ob[i], a) and torch.equal(ow[i], bw)
    assert ob[0, 1] < 0                    # wrapped
    assert ob[1, 0] == bnd[1, 0]           # restarted
    assert ow[1, 1, 0] == w[1, 1, 0]


def test_batched_monotone_gather_twin_equals_single_twins():
    rng = np.random.default_rng(3)
    vals = torch.from_numpy(rng.integers(-9, 9, (3, 4, 40)).astype(np.int32))
    rid = _wild(rng, (3, 99), 40)
    out = tmg.monotone_gather_batched(vals, rid)
    assert out.shape == (3, 4, 99)
    for i in range(3):
        assert torch.equal(out[i], tmg.plain_gather(vals[i], rid[i]))


def test_batched_wrappers_refuse_other_devices_and_shapes():
    meta = torch.empty((2, 3, 4), dtype=torch.int64, device="meta")
    midx = torch.empty((2, 5), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfr.plane_rows_batched(meta, midx)
    with pytest.raises(ValueError):
        tmg.monotone_gather_batched(torch.zeros((2, 3, 4), dtype=torch.int32),
                                    torch.zeros((3, 5), dtype=torch.int32))
    with pytest.raises(ValueError):
        tts.prefix_sums_batched(torch.zeros((2, 5), dtype=torch.int32),
                                torch.zeros((3, 1, 5), dtype=torch.int32))


# -- one chain a batch --------------------------------------------------------

def _chain_cols(n_replicas, n):
    from crdt_graph_tpu_torch.bench import workloads
    return workloads.chain_workload(n_replicas, n)


def _vouched(arrs, n):
    """A vouched ``PackedOps`` over generated columns."""
    return tpacked.PackedOps(
        **{k: arrs[k] for k in ("kind", "ts", "parent_ts", "anchor_ts",
                                "depth", "paths", "value_ref", "pos",
                                "parent_pos", "anchor_pos", "target_pos",
                                "ts_rank")},
        values=list(range(n)), num_ops=n, hints_vouched=True)


def _audit(cols, hints="join"):
    nd = tmerge.host_no_deletes(cols["kind"])
    return chainaudit.audit_materialize(cols, hints, nd, "cpu")


# what a batch may cost over its costliest document's single merge: the
# per-document reductions behind each tier read (a max or an all over
# the batch), the contiguous copies of a batch's sliced run ids and
# search keys; reads only as many more as one extra tier choice
BATCH_EXTRA_OPS = 16
BATCH_EXTRA_READS = 2


@pytest.mark.parametrize("hints", ["join", "exhaustive"])
def test_batch_of_eight_is_one_merge(hints):
    """A B = 8 batch makes one merge's dispatches and reads (within the
    stated constants of the costliest of its documents' own merges), not
    eight times them; each kernel is one call."""
    stacked, aligned = tmesh.stack_aligned(
        [_vouched(_chain_cols(4 << i, 2048), 2048) for i in range(8)])
    cols = {k: stacked[k] for k in stacked
            if hints == "exhaustive" or k not in tmesh.POS_HINTS}
    batch = _audit(cols, hints)
    singles = [_audit(p.arrays(), hints) for p in aligned]
    assert batch.merges == 1 and batch.docs == [8]
    assert batch.device_ops <= max(s.device_ops for s in singles) + \
        BATCH_EXTRA_OPS
    assert batch.read_syncs <= max(s.read_syncs for s in singles) + \
        BATCH_EXTRA_READS
    assert batch.device_ops < 2 * min(s.device_ops for s in singles)
    want = {k + "_batched": n for k, n in singles[0].kernel_calls.items()}
    assert batch.kernel_calls == want
    assert batch.hidden_syncs == 0


def test_converged_document_unchanged_by_extra_rounds(monkeypatch):
    """A small valid document needs fewer loop rounds (no invalid node
    to cascade, no anchor above its node) than the hostile one; in one
    batch the loops run until the hostile one converges, and the small
    one's table is its single merge's all the same."""
    short = _PACKED[7][1]
    deep = _PACKED[4][1]
    stacked, aligned = tmesh.stack_aligned([short, deep])
    a_short = _audit(aligned[0].arrays())
    a_batch = _audit({k: v for k, v in stacked.items()
                      if k not in tmesh.POS_HINTS})
    loops = lambda a: sum(1 for r in a.rows  # noqa: E731
                          if r[4] == "loop" and r[1].endswith("[read]"))
    assert loops(a_batch) > loops(a_short)
    btab = tmesh.batched_materialize(stacked, device="cpu")
    _assert_fields_equal(_np(tmesh.doc_table(btab, 0)),
                         _np(tmerge.materialize(aligned[0].arrays(),
                                                hints="join", device="cpu")),
                         "short doc")


def test_wider_tier_for_the_batch_changes_no_field(monkeypatch):
    """Documents that want different tiers (the single-group shortcut,
    a small compact sibling width, run counts on both sides of R_CAP):
    the batch takes one tier that fits its largest document for all,
    and every slice is its own single merge, which took its own."""
    widths = []
    real_sib, real_mg = tmerge._sib_links, tmerge._monotone_gather

    def sib(kp, *a):
        widths.append(("sib", kp.shape[-1]))
        return real_sib(kp, *a)

    def mg(values, rid):
        widths.append(("runs", values.shape[-1]))
        return real_mg(values, rid)

    monkeypatch.setattr(tmerge, "_sib_links", sib)
    monkeypatch.setattr(tmerge, "_monotone_gather", mg)
    few, many, group = _PACKED[6][1], _PACKED[1][1], _PACKED[5][1]
    stacked, aligned = tmesh.stack_aligned([few, many, group])
    tiers = []
    singles = []
    for p in aligned:
        widths.clear()
        singles.append(_np(tmerge.materialize(p.arrays(), hints="join",
                                              device="cpu")))
        tiers.append(list(widths))
    assert len({tuple(t) for t in tiers}) == 3, tiers
    widths.clear()
    btab = tmesh.batched_materialize(stacked, device="cpu")
    batch_tier = list(widths)
    # the run pipeline at the widest document's width; the sibling sort
    # at a width that fits the most crowded document (the single-group
    # shortcut needs every document to be one group: the chain is not)
    run_w = lambda t: [w for k, w in t if k == "runs"]  # noqa: E731
    sib_w = lambda t: [w for k, w in t if k == "sib"]   # noqa: E731
    assert run_w(batch_tier) == [max(max(run_w(t)) for t in tiers)]
    assert len(sib_w(batch_tier)) == 1
    assert all(sib_w(batch_tier)[0] >= w for t in tiers for w in sib_w(t))
    for i in range(3):
        _assert_fields_equal(_np(tmesh.doc_table(btab, i)), singles[i],
                             f"doc {i}")


def test_document_without_deletes_through_the_delete_stage():
    """A batch holds deletes in one document: the others run the delete
    machinery and still give their no-deletes tables."""
    with_del, plain = _PACKED[2][1], _PACKED[3][1]
    stacked, aligned = tmesh.stack_aligned([with_del, plain])
    assert not tmerge.host_no_deletes(stacked["kind"])
    assert tmerge.host_no_deletes(aligned[1].arrays()["kind"])
    btab = tmesh.batched_materialize(stacked, device="cpu")
    _assert_fields_equal(_np(tmesh.doc_table(btab, 1)),
                         _np(tmerge.materialize(aligned[1].arrays(),
                                                hints="join", device="cpu")),
                         "no-deletes doc")


def test_large_batch_splits_by_the_row_rule(monkeypatch):
    """A batch past ``BATCH_ROWS`` op rows merges in sub-batches of
    ``BATCH_ROWS // N`` documents, and the table is the whole batch's."""
    _, tdocs = _docs(8)
    stacked, _ = tmesh.stack_aligned(tdocs)
    whole = _np(tmesh.batched_materialize(stacked, device="cpu"))
    n = stacked["kind"].shape[1]
    monkeypatch.setattr(tmesh, "BATCH_ROWS", 3 * n)
    calls = []
    real = tmerge._materialize

    def spy(ops, *a, **kw):
        calls.append(ops["kind"].shape[0])
        return real(ops, *a, **kw)

    monkeypatch.setattr(tmerge, "_materialize", spy)
    split = _np(tmesh.batched_materialize(stacked, device="cpu"))
    assert calls == [3, 3, 2]
    _assert_fields_equal(split, whole, "split")


def test_mesh_rows_on_one_device_merge_as_one_batch(monkeypatch):
    """Docs rows that start on the same device (logical devices of one
    card) are one batched merge; distinct devices are not merged
    together."""
    _, tdocs = _docs(8)
    stacked, _ = tmesh.stack_aligned(tdocs)
    calls = []
    real = tmerge._materialize

    def spy(ops, hints, dev, *a, **kw):
        calls.append((ops["kind"].shape[0], str(dev)))
        return real(ops, hints, dev, *a, **kw)

    monkeypatch.setattr(tmerge, "_materialize", spy)
    m = tmesh.make_mesh(4, 1, devices=["cpu"] * 4)
    got = _np(tmesh.batched_materialize(stacked, m))
    assert calls == [(8, "cpu")]
    _assert_fields_equal(got, _np(tmesh.batched_materialize(
        stacked, device="cpu")), "mesh")
