"""The port's timestamp index (``codec.packed.TsIndex``) and the union's
cross-part reference resolution (``codec.packed.concat_many``), on the CPU.

The index is held to a plain dict built in a loop (each add timestamp →
the first add row carrying it), and ``concat_many``'s link hints to the
per-reference dict probe in part order that the union resolved its open
references with before (first part wins, -1 where no part holds the
timestamp), written out here as the reference.
"""
import numpy as np
import pytest

from crdt_graph_tpu_torch.codec import packed as tpacked
from crdt_graph_tpu_torch.core.operation import Add, Delete

ADD, DEL, PAD = tpacked.KIND_ADD, tpacked.KIND_DELETE, tpacked.KIND_PAD
HINTS = (("parent_pos", "parent_ts"), ("anchor_pos", "anchor_ts"),
         ("target_pos", "ts"))


def ts(r, c):
    return r * 2**32 + c


def _part(kind, tss, parent=None, anchor=None, cap=None):
    """A PackedOps over the given rows (depth 2 paths), padded to ``cap``
    with nonzero timestamps in the padding, which no index may read."""
    n = len(kind)
    cap = cap or max(8, n)
    cols = {"kind": np.full(cap, PAD, np.int8),
            "ts": np.arange(cap, dtype=np.int64) + ts(99, 1),
            "parent_ts": np.zeros(cap, np.int64),
            "anchor_ts": np.zeros(cap, np.int64),
            "depth": np.full(cap, 2, np.int32)}
    cols["kind"][:n] = kind
    cols["ts"][:n] = tss
    if parent is not None:
        cols["parent_ts"][:n] = parent
    if anchor is not None:
        cols["anchor_ts"][:n] = anchor
    paths = np.stack([cols["parent_ts"], cols["anchor_ts"]], axis=1)
    return tpacked.PackedOps(
        kind=cols["kind"], ts=cols["ts"], parent_ts=cols["parent_ts"],
        anchor_ts=cols["anchor_ts"], depth=cols["depth"], paths=paths,
        value_ref=np.full(cap, -1, np.int32),
        pos=np.arange(cap, dtype=np.int32), values=[], num_ops=n)


def _chains(seed, replicas, per):
    """``replicas`` insertion chains of ``per`` adds, interleaved from the
    seed, each chain in its own order."""
    rng = np.random.default_rng(seed)
    rid = np.repeat(np.arange(1, replicas + 1, dtype=np.int64), per)
    counter = np.tile(np.arange(1, per + 1, dtype=np.int64), replicas)
    keys = np.sort(rng.random((replicas, per)), axis=1).ravel()
    order = np.argsort(keys, kind="stable")
    t = (rid * 2**32 + counter)[order]
    return _part(np.zeros(t.size, np.int8), t, anchor=np.where(
        counter[order] == 1, 0, t - 1))


INDEX_CASES = {
    "empty": lambda: _part([], []),
    "padding": lambda: _part([ADD, ADD, PAD, ADD],
                             [ts(1, 2), ts(1, 1), ts(1, 3), ts(2, 1)],
                             cap=16),
    "delete_same_ts": lambda: _part([DEL, ADD, DEL, ADD],
                                    [ts(1, 1), ts(1, 1), ts(1, 2),
                                     ts(1, 3)]),
    "duplicates": lambda: _part([ADD] * 9 + [DEL],
                                [ts(3, 1), ts(1, 1), ts(3, 1), ts(1, 1),
                                 ts(2, 5), ts(3, 1), ts(1, 1), ts(2, 5),
                                 ts(2, 4), ts(2, 4)]),
    "ts_zero": lambda: _part([ADD, ADD, ADD], [ts(1, 1), 0, 0]),
    "one_row": lambda: _part([ADD], [ts(7, 7)]),
    "chains_50k": lambda: _chains(19, 50, 1000),
}


def _first_add(p):
    """The reference: each add timestamp → its first add row, in a loop."""
    first = {}
    for i in range(p.num_ops):
        if p.kind[i] == ADD and int(p.ts[i]) not in first:
            first[int(p.ts[i])] = i
    return first


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_index_is_the_first_add_row_per_timestamp(case):
    p = INDEX_CASES[case]()
    want = _first_add(p)
    idx = p.index()
    assert isinstance(idx, tpacked.TsIndex)
    assert p.index() is idx                       # cached on the part
    assert len(idx) == len(want)
    assert np.all(np.diff(idx.keys) > 0)
    assert dict(zip(idx.keys.tolist(), idx.rows.tolist())) == want
    misses = [ts(98, 1), ts(99, 1), -1, 1] + ([0] if 0 not in want else [])
    for t in list(want)[:2000] + misses:
        got = idx.get(t)
        assert got == want.get(t), t
        assert got is None or type(got) is int
    assert idx.get(2**70) is None and idx.get(-2**70) is None
    probe = np.array(list(want) + misses, dtype=np.int64)
    np.testing.assert_array_equal(
        idx.lookup(probe), [want.get(int(t), -1) for t in probe])
    assert idx.lookup(np.zeros(0, np.int64)).shape == (0,)


def test_pack_hands_over_the_same_index():
    ops = [Add(ts(1, 1), (0,), "a"), Add(ts(1, 2), (ts(1, 1),), "b"),
           Delete((ts(1, 1),)), Add(ts(1, 1), (0,), "dup"),
           Add(ts(2, 1), (ts(1, 2),), "c")]
    p = tpacked.pack(ops, max_depth=4)
    assert isinstance(p.ts_index, tpacked.TsIndex)
    assert dict(zip(p.ts_index.keys.tolist(),
                    p.ts_index.rows.tolist())) == _first_add(p) == {
        ts(1, 1): 0, ts(1, 2): 1, ts(2, 1): 4}


# -- concat_many -------------------------------------------------------------

def _old_concat_hints(parts):
    """The link hint columns of the union as the per-reference probe of
    each part's dict index, in part order, resolved them."""
    parts = [p for p in parts if p.num_ops]
    dicts = [_first_add(p) for p in parts]
    bases = np.cumsum([0] + [p.num_ops for p in parts[:-1]]).tolist()

    def probe(t):
        for d, b in zip(dicts, bases):
            if t in d:
                return d[t] + b
        return -1

    out = {name: [] for name, _ in HINTS}
    for p, base in zip(parts, bases):
        k = p.num_ops
        for name, ref_col in HINTS:
            h = getattr(p, name)[:k].astype(np.int64)
            refs = getattr(p, ref_col)[:k]
            unresolved = h < 0
            h[~unresolved] += base
            if name == "target_pos":
                unresolved &= p.kind[:k] == DEL
            elif name == "anchor_pos":
                unresolved &= p.kind[:k] == ADD
            for i in np.nonzero(unresolved & (refs != 0))[0]:
                h[i] = probe(int(refs[i]))
            out[name].append(h)
    return {name: np.concatenate(v) for name, v in out.items()}


def _random_part(rng, pool, unknown, n, how):
    """``n`` rows of adds and deletes whose timestamps and references come
    from ``pool`` (shared by all parts, so timestamps repeat across and
    within parts) and ``unknown`` (held by no part).  ``how``: "vouched"
    (internal hints rebuilt), "bare" (no hints: every ref is probed),
    "indexed" (vouched, index cached before the union) or "packed" (built
    by ``pack``)."""
    kind = np.where(rng.random(n) < 0.75, ADD, DEL).astype(np.int8)
    refs = np.concatenate([pool, unknown, [0, 0]])
    tss = np.where(kind == ADD, rng.choice(pool, n), rng.choice(refs, n))
    parent = rng.choice(refs, n)
    anchor = np.where(kind == ADD, rng.choice(refs, n), 0)
    if how == "packed":
        ops = [Add(int(t), (int(pp), int(a)), i) if k == ADD
               else Delete((int(pp), int(t)))
               for i, (k, t, pp, a) in enumerate(zip(kind, tss, parent,
                                                     anchor))]
        return tpacked.pack(ops, max_depth=4)
    p = _part(kind, tss, parent=parent, anchor=anchor,
              cap=int(rng.choice([n, 2 * n + 3])))
    if how != "bare":
        tpacked.rebuild_hints(p)
    if how == "indexed":
        p.index()
    return p


UNIONS = [(seed, hows) for seed, hows in enumerate([
    ("vouched", "vouched"),
    ("bare", "vouched", "packed"),
    ("indexed", "bare", "bare", "vouched"),
    ("packed", "indexed", "packed"),
    ("vouched", "empty", "bare", "indexed", "packed"),
    ("bare", "bare"),
])]


@pytest.mark.parametrize("seed,hows", UNIONS)
def test_concat_many_resolves_as_the_per_reference_probe(seed, hows):
    rng = np.random.default_rng(1000 + seed)
    pool = np.array([ts(r, c) for r in range(1, 5) for c in range(1, 40)],
                    np.int64)
    unknown = np.array([ts(9, c) for c in range(1, 6)], np.int64)
    parts = [_part([], []) if how == "empty" else
             _random_part(rng, pool, unknown, int(rng.integers(1, 120)), how)
             for how in hows]
    want = _old_concat_hints(parts)
    live = [p for p in parts if p.num_ops]
    out = tpacked.concat_many(parts)
    n = sum(p.num_ops for p in live)
    assert out.num_ops == n
    for name, _ in HINTS:
        col = getattr(out, name)
        np.testing.assert_array_equal(col[:n], want[name], err_msg=name)
        assert (col[n:] == -1).all(), name
    # every kind of reference is in the cases: into earlier and later
    # parts, to a timestamp added in more than one part, and nowhere
    bases = np.cumsum([0] + [p.num_ops for p in live]).tolist()
    part_of = np.searchsorted(bases, np.arange(n), side="right") - 1
    hint_rows = np.concatenate([want[name] for name, _ in HINTS])
    from_part = np.tile(part_of, len(HINTS))
    to = hint_rows >= 0
    to_part = part_of[hint_rows[to]]
    if len(live) > 1:
        assert (to_part < from_part[to]).any()
        assert (to_part > from_part[to]).any()
    assert (hint_rows == -1).any()
    np.testing.assert_array_equal(
        out.ts_rank, tpacked.compute_ts_rank(out.kind, out.ts))
    assert out.hints_vouched == all(p.hints_vouched for p in live)
    for name in ("kind", "ts", "parent_ts", "anchor_ts", "depth"):
        np.testing.assert_array_equal(
            getattr(out, name)[:n],
            np.concatenate([getattr(p, name)[:p.num_ops] for p in live]))


def test_concat_many_prefers_the_first_part_holding_a_timestamp():
    a = _part([ADD, ADD], [ts(1, 1), ts(2, 1)])
    b = _part([ADD, ADD], [ts(2, 1), ts(1, 1)])
    c = _part([ADD, DEL, ADD], [ts(3, 1), ts(2, 1), ts(3, 2)],
              anchor=[ts(1, 1), 0, ts(8, 8)])
    for p in (a, b, c):
        tpacked.rebuild_hints(p)
    out = tpacked.concat_many([b, a, c])
    assert out.anchor_pos[4:7].tolist() == [1, -1, -1]
    assert out.target_pos[4:7].tolist() == [-1, 0, -1]


@pytest.mark.parametrize("seed", range(4))
def test_rebuild_hints_resolves_each_ref_to_its_first_add(seed):
    """``rebuild_hints`` resolves through the same index: each nonzero
    reference below ``MAX_TS`` to the first add row carrying it."""
    rng = np.random.default_rng(2000 + seed)
    pool = np.array([ts(r, c) for r in range(1, 4) for c in range(1, 30)]
                    + [0, tpacked.MAX_TS], np.int64)
    p = _random_part(rng, pool, np.array([ts(9, 1)], np.int64), 150,
                     "bare")
    p.kind[int(rng.integers(0, 150))] = PAD
    tpacked.rebuild_hints(p)
    first = {t: i for t, i in _first_add(p).items() if t > 0}
    for name, ref_col in HINTS:
        active = {"parent_pos": p.kind != PAD, "anchor_pos": p.kind == ADD,
                  "target_pos": p.kind == DEL}[name]
        refs = getattr(p, ref_col)
        want = [first.get(int(t), -1) if a and 0 < t < tpacked.MAX_TS
                else -1 for t, a in zip(refs, active)]
        np.testing.assert_array_equal(getattr(p, name), want, err_msg=name)
    assert p.hints_vouched and tpacked.verify_hints(p)
