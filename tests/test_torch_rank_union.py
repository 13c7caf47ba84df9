"""The union's timestamp ranks and a part's timestamp index taken from the
parts' ``ts_rank`` columns (``codec.packed.concat_many``,
``PackedOps.index``), on the CPU.

Both are held, bit for bit, to the sorts they stand in for:
``compute_ts_rank`` over the concatenated columns and
``TsIndex.of_adds`` over the part's adds.  A part's rank that is not
its adds' rank (tampered with, or left at -1) must send the union, or
the part's index, to that sort, as must an add at ``ts <= 0`` the
index; the counts ``packed.rank_reused`` and ``packed.rank_resorted``
say which rows took which way.
"""
import collections

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from crdt_graph_tpu_torch.codec import packed as tpacked
from crdt_graph_tpu_torch.utils import profiling as tprof

ADD, DEL, PAD = tpacked.KIND_ADD, tpacked.KIND_DELETE, tpacked.KIND_PAD


def ts(r, c):
    return r * 2**32 + c


def _part(kind, tss, cap=None, width=1):
    """A PackedOps over the given rows, padded to ``cap`` with nonzero
    timestamps in the padding, which no rank or index may read; its
    ``ts_rank`` as ``__post_init__`` computes it."""
    kind = np.asarray(kind, np.int8)
    n = kind.size
    cap = cap or max(8, n)
    k = np.full(cap, PAD, np.int8)
    k[:n] = kind
    t = np.arange(cap, dtype=np.int64) + ts(99, 1)
    t[:n] = tss
    return tpacked.PackedOps(
        kind=k, ts=t, parent_ts=np.zeros(cap, np.int64),
        anchor_ts=np.zeros(cap, np.int64), depth=np.ones(cap, np.int32),
        paths=np.tile(t[:, None], (1, width)),
        value_ref=np.full(cap, -1, np.int32),
        pos=np.arange(cap, dtype=np.int32), values=[], num_ops=n)


def _chains(seed, replicas, start, count):
    """Counters ``start+1 .. start+count`` of ``replicas`` insertion
    chains, rows interleaved from the seed, as the catch-up cell's."""
    rng = np.random.default_rng(seed)
    rid = np.repeat(np.arange(1, replicas + 1, dtype=np.int64), count)
    counter = np.tile(np.arange(start + 1, start + count + 1,
                                dtype=np.int64), replicas)
    keys = np.sort(rng.random((replicas, count)), axis=1).ravel()
    order = np.argsort(keys, kind="stable")
    t = (rid * 2**32 + counter)[order]
    return _part(np.full(t.size, ADD), t, cap=tpacked._bucket(t.size))


def _mixed(seed, n, pool, cap=None, width=1):
    """``n`` adds, deletes and pads over timestamps drawn from ``pool``
    (so they repeat within and across parts; zero and negative ones
    included where the pool has them)."""
    rng = np.random.default_rng(seed)
    kind = rng.choice([ADD, ADD, ADD, DEL, PAD], n)
    return _part(kind, rng.choice(pool, n), cap=cap, width=width)


def _tampered(p, how):
    if how == "unset":
        p.ts_rank[:] = -1
    elif how == "swapped":
        ranked = np.nonzero(p.ts_rank[:p.num_ops] >= 0)[0]
        a, b = ranked[0], ranked[-1]
        p.ts_rank[a], p.ts_rank[b] = p.ts_rank[b], p.ts_rank[a]
    elif how == "shifted":     # no row holds rank 0
        p.ts_rank[p.ts_rank >= 0] += 1
    else:   # "skipped": a rank no row holds below the top
        p.ts_rank[p.ts_rank > 0] += 1
    return p


def _crossed():
    """A row of a duplicated timestamp that claims the next timestamp's
    rank: every rank held, the scattered keys increasing, and still not
    the adds' rank."""
    p = _part([ADD] * 5, [ts(1, 1), ts(1, 2), ts(1, 2), ts(1, 3),
                          ts(1, 3)])
    p.ts_rank[2] += 1
    return p


POOL = np.array([ts(r, c) for r in range(1, 5) for c in range(1, 30)],
                np.int64)
# each case: (parts, indexes of the parts whose rank fails the proof)
UNION_CASES = {
    "two_chains": lambda: ([_chains(1, 64, 0, 64), _chains(2, 64, 64, 24)],
                           []),
    "three_chains": lambda: ([_chains(3, 16, 0, 40), _chains(4, 16, 40, 9),
                              _chains(5, 16, 49, 30)], []),
    "disjoint": lambda: ([_part([ADD] * 3, [ts(5, 1), ts(5, 3), ts(5, 2)]),
                          _part([ADD] * 2, [ts(1, 2), ts(1, 1)]),
                          _part([ADD] * 2, [ts(9, 1), ts(8, 1)])], []),
    "duplicates": lambda: ([_mixed(6, 90, POOL[:20]),
                            _mixed(7, 70, POOL[10:30])], []),
    "deletes_pads_nonpositive": lambda: ([
        _mixed(8, 60, np.concatenate([POOL, [0, -5]]), cap=70),
        _mixed(9, 50, np.concatenate([POOL, [0, -7]]), cap=128)], []),
    "empty_part": lambda: ([_mixed(10, 40, POOL), _part([], []),
                            _mixed(11, 30, POOL)], []),
    "one_sided_empty_keys": lambda: ([_part([DEL, PAD], [ts(1, 1), 0]),
                                      _mixed(12, 30, POOL)], []),
    "mixed_widths": lambda: ([_mixed(13, 40, POOL, width=1),
                              _mixed(14, 40, POOL, width=4),
                              _mixed(15, 40, POOL, width=2)], []),
    "tampered_unset": lambda: ([_mixed(16, 50, POOL),
                                _tampered(_mixed(17, 50, POOL), "unset")],
                               [1]),
    "tampered_swapped": lambda: ([_tampered(_chains(18, 8, 0, 20),
                                            "swapped"),
                                  _chains(19, 8, 20, 5)], [0]),
    "tampered_skipped": lambda: ([_mixed(20, 40, POOL),
                                  _tampered(_mixed(21, 40, POOL), "skipped"),
                                  _mixed(22, 40, POOL)], [1]),
    "tampered_shifted": lambda: ([_tampered(_mixed(23, 40, POOL), "shifted"),
                                  _mixed(24, 40, POOL)], [0]),
    "tampered_crossed": lambda: ([_mixed(25, 30, POOL), _crossed()], [1]),
    "many_tickets": lambda: ([_mixed(26 + i, 1 + i % 3, POOL)
                              for i in range(40)], []),
    "many_tickets_one_tampered": lambda: (
        [_mixed(70 + i, 3, POOL[:12]) for i in range(9)]
        + [_tampered(_mixed(79, 6, POOL[:12]), "unset")], [9]),
}


def _ranked_rows(p):
    k = p.num_ops
    return int(np.count_nonzero((p.kind[:k] == ADD) & (p.ts[:k] > 0)))


def _counts(name):
    """{count: total} over the span log's ``name`` records."""
    out = collections.Counter()
    for r in tprof.span_log()["records"]:
        if r["name"] == name:
            out.update(r["counts"])
    return out


@pytest.fixture(autouse=True)
def _fresh_log():
    tprof.reset_spans()
    yield
    tprof.reset_spans()


@pytest.mark.parametrize("case", sorted(UNION_CASES))
def test_union_rank_is_the_sort_of_the_union(case):
    parts, resorted = UNION_CASES[case]()
    live = [p for p in parts if p.num_ops]
    assert len(live) > 1
    before = [p.ts_rank.copy() for p in parts]
    with profile(activities=[ProfilerActivity.CPU]):
        out = tpacked.concat_many(parts)
    want = tpacked.compute_ts_rank(out.kind, out.ts)
    assert out.ts_rank.dtype == np.int32
    np.testing.assert_array_equal(out.ts_rank, want)
    assert (out.ts_rank[out.num_ops:] == -1).all()
    for p, r in zip(parts, before):          # the parts keep their ranks
        np.testing.assert_array_equal(p.ts_rank, r)
    # one part that fails sends the whole union to the sort
    way = "resorted" if resorted else "reused"
    assert _counts("packed.ts_rank") == {
        f"packed.rank_{way}": sum(_ranked_rows(p) for p in live)}


@pytest.mark.parametrize("seed", range(6))
def test_union_rank_of_random_parts_with_shared_timestamps(seed):
    rng = np.random.default_rng(300 + seed)
    pool = rng.integers(-2, 60, 40) * 2**32 + rng.integers(1, 9, 40)
    parts = [_mixed(seed * 10 + i, int(rng.integers(0, 80)), pool,
                    cap=int(rng.integers(80, 90)),
                    width=int(rng.choice([1, 2, 8])))
             for i in range(int(rng.integers(2, 6)))]
    if sum(p.num_ops > 0 for p in parts) < 2:
        parts.append(_mixed(seed, 10, pool))
    out = tpacked.concat_many(parts)
    np.testing.assert_array_equal(
        out.ts_rank, tpacked.compute_ts_rank(out.kind, out.ts))


INDEX_CASES = {
    "chains": (lambda: _chains(30, 32, 0, 50), "reused"),
    "duplicates": (lambda: _part(
        [ADD] * 9 + [DEL],
        [ts(3, 1), ts(1, 1), ts(3, 1), ts(1, 1), ts(2, 5), ts(3, 1),
         ts(1, 1), ts(2, 5), ts(2, 4), ts(2, 4)]), "reused"),
    "deletes_pads": (lambda: _mixed(31, 70, POOL[:25], cap=100), "reused"),
    "empty": (lambda: _part([], []), "reused"),
    "ts_zero": (lambda: _part([ADD, ADD, ADD], [ts(1, 1), 0, ts(1, 2)]),
                "resorted"),
    "ts_negative": (lambda: _part([ADD, DEL, ADD], [ts(1, 1), 0, -3]),
                    "resorted"),
    "rank_unset": (lambda: _tampered(_mixed(32, 40, POOL), "unset"),
                   "resorted"),
    "rank_swapped": (lambda: _tampered(_chains(33, 4, 0, 10), "swapped"),
                     "resorted"),
    "rank_skipped": (lambda: _tampered(_mixed(34, 40, POOL), "skipped"),
                     "resorted"),
    "rank_shifted": (lambda: _tampered(_mixed(35, 40, POOL), "shifted"),
                     "resorted"),
    "rank_crossed": (_crossed, "resorted"),
}


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_index_from_the_rank_is_the_sorted_index(case):
    make, way = INDEX_CASES[case]
    p = make()
    add_rows = np.nonzero(p.kind[:p.num_ops] == ADD)[0]
    want = tpacked.TsIndex.of_adds(p.ts, add_rows)
    with profile(activities=[ProfilerActivity.CPU]):
        idx = p.index()
    for name in ("keys", "rows"):
        got, exp = getattr(idx, name), getattr(want, name)
        assert got.dtype == exp.dtype, name
        np.testing.assert_array_equal(got, exp, err_msg=name)
    counts = _counts("packed.ts_index")
    assert counts == {"packed.index_rows": add_rows.size,
                      f"packed.rank_{way}": add_rows.size}


def test_index_keeps_each_duplicate_timestamps_smallest_row():
    p = _part([ADD] * 6, [ts(2, 1), ts(1, 1), ts(2, 1), ts(2, 1),
                          ts(1, 1), ts(3, 1)])
    idx = p.index()
    assert idx.keys.tolist() == [ts(1, 1), ts(2, 1), ts(3, 1)]
    assert idx.rows.tolist() == [1, 0, 5]


def test_concat_leaves_no_index_but_on_the_parts_it_probed():
    base = _chains(40, 8, 0, 30)
    delta = _chains(41, 8, 30, 10)
    # the delta's chain heads name the base's last adds: only the base
    # is probed
    delta.anchor_ts[:delta.num_ops] = delta.ts[:delta.num_ops] - 1
    tpacked.rebuild_hints(delta)
    out = tpacked.concat_many([base, delta])
    assert out.ts_index is None
    assert base.ts_index is not None and delta.ts_index is None
    np.testing.assert_array_equal(
        out.ts_rank, tpacked.compute_ts_rank(out.kind, out.ts))
    # no open reference: no part is probed
    a, b = _chains(42, 4, 0, 5), _chains(43, 4, 5, 5)
    out = tpacked.concat_many([a, b])
    assert out.ts_index is None and a.ts_index is None \
        and b.ts_index is None
