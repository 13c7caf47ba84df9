"""The union of packed batches built in one row of a column frame
(``codec.packed.concat_many(parts, out=row)``), on the CPU.

The row is held to the union built in fresh arrays and re-padded to the
row's length (``with_capacity``), column for column; its pad tail and
the path columns past the union's width to what ``pad_arrays`` fills;
its shape rule to ``union_shape``.  A row too short or too narrow for
the union raises before a byte of the frame changes, and the frame's
other rows are never written.
"""
import numpy as np
import pytest

from crdt_graph_tpu_torch.codec import packed as tpacked
from crdt_graph_tpu_torch.core.operation import Add, Delete

GARBAGE = 77        # what the frame holds before a union is built in it


def ts(r, c):
    return r * 2**32 + c


def _part(rng, j, n, depth, shared):
    """``n`` adds and deletes of replica ``j + 1``, paths ``depth`` deep,
    packed with their values and link hints.  References reach into the
    parts of replicas 1..3, so a union resolves some across parts; with
    ``shared`` the part ends with an add of ``ts(1, 1)``, which replica
    1's part also begins with."""
    own = rng.choice(np.arange(1, 4 * n), n, replace=False)
    refs = [0] + [ts(r, c) for r in range(1, 4) for c in range(1, 20)]
    ops = []
    for i, c in enumerate(own):
        head = tuple(int(x) for x in rng.choice(refs, depth - 1))
        if rng.random() < 0.25:
            ops.append(Delete(head + (int(rng.choice(refs[1:])),)))
        else:
            anchor = int(rng.choice(refs))
            ops.append(Add(ts(j + 1, int(c)), head + (anchor,), f"{j}.{i}"))
    if shared:
        dup = Add(ts(1, 1), (0,), "dup")
        ops = ([dup] if j == 0 else []) + ops + [dup]
    return tpacked.pack(ops)


def _parts(n_parts, shared, seed=0):
    """Parts of path widths 2, 1 and 4, in that order."""
    rng = np.random.default_rng(seed + 10 * n_parts + shared)
    return [_part(rng, j, 30 + 17 * j, d, shared)
            for j, d in zip(range(n_parts), (2, 1, 3))]


def _frame(docs, n, width):
    fr = tpacked.frame(docs, n, width)
    for v in fr.values():
        v.fill(GARBAGE)
    return fr


def _row(fr, i):
    return {k: v[i] for k, v in fr.items()}


def _assert_columns(got, want):
    for k, col in want.columns().items():
        g = getattr(got, k)
        assert g.shape == col.shape and g.dtype == col.dtype, k
        np.testing.assert_array_equal(g, col, err_msg=k)


@pytest.mark.parametrize("shared", [False, True], ids=["distinct", "shared"])
@pytest.mark.parametrize("n_parts", [1, 2, 3])
def test_the_row_holds_the_union_built_apart(n_parts, shared):
    parts = _parts(n_parts, shared)
    if n_parts == 1:
        parts[0].index()        # a lone part's cached index carries over
    want = tpacked.concat_many(parts)
    cap, width = tpacked.union_shape(parts)
    assert (cap, width) == (want.capacity, want.max_depth)
    rows, wide = 2 * cap, width + 2
    fr = _frame(2, rows, wide)
    got = tpacked.concat_many(parts, out=_row(fr, 1))

    assert got.kind.base is fr["kind"] and got.paths.base is fr["paths"]
    _assert_columns(got, tpacked.with_capacity(want, rows))
    assert got.values == want.values
    assert (got.num_ops, got.hints_vouched) == (want.num_ops,
                                                want.hints_vouched)
    assert got.ts_index is (parts[0].ts_index if n_parts == 1 else None)

    # the whole row: the live rows, padded as pad_arrays pads them, the
    # path columns past the union's width zero
    n = want.num_ops
    live = {k: v[:n] for k, v in want.columns().items()}
    live["paths"] = np.pad(live["paths"], [(0, 0), (0, wide - width)])
    padded = tpacked.pad_arrays(live, rows)
    assert list(padded) == list(fr)
    for k, v in padded.items():
        assert v.dtype == fr[k].dtype, k
        np.testing.assert_array_equal(fr[k][1], v, err_msg=k)
        assert (fr[k][0] == GARBAGE).all(), k


def test_the_shared_cases_hold_a_duplicate_timestamp():
    for n_parts in (1, 2, 3):
        u = tpacked.concat_many(_parts(n_parts, True))
        adds = u.ts[:u.num_ops][u.kind[:u.num_ops] == tpacked.KIND_ADD]
        assert np.unique(adds).size < adds.size
        u = tpacked.concat_many(_parts(n_parts, False))
        adds = u.ts[:u.num_ops][u.kind[:u.num_ops] == tpacked.KIND_ADD]
        assert np.unique(adds).size == adds.size


def test_a_union_of_no_rows_pads_the_whole_row():
    empty = tpacked.pack([])
    assert tpacked.union_shape([]) == tpacked.union_shape([empty]) == (
        empty.capacity, empty.max_depth)
    fr = _frame(1, 16, 2)
    got = tpacked.concat_many([empty], out=_row(fr, 0))
    assert got.num_ops == 0 and got.capacity == 16
    padded = tpacked.pad_arrays(
        {k: np.zeros((0, 2) if k == "paths" else 0, dt)
         for k, dt in tpacked.COLUMN_DTYPES.items()}, 16)
    for k, v in padded.items():
        np.testing.assert_array_equal(fr[k][0], v, err_msg=k)


@pytest.mark.parametrize("short", ["rows", "width"])
@pytest.mark.parametrize("n_parts", [1, 3])
def test_a_short_or_narrow_row_raises_before_writing(n_parts, short):
    parts = _parts(n_parts, False)
    cap, width = tpacked.union_shape(parts)
    fr = _frame(1, cap - 1 if short == "rows" else cap,
                width - 1 if short == "width" else width)
    with pytest.raises(ValueError):
        tpacked.concat_many(parts, out=_row(fr, 0))
    for k, v in fr.items():
        assert (v == GARBAGE).all(), k

