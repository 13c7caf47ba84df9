"""The generators repeat from a seed, keep their sizes across seeds, and
give causally valid columns whose link hints point at the right rows."""
import numpy as np
import pytest

from crdtbench.gen import chains, rng_for

SEEDS = (0, 2**31 + 5, -7, 9_223_372_036_854_775_000)


def _same(a, b):
    return all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("seed", SEEDS)
def test_chain_rows_repeat_from_seed(seed):
    a, va = chains.chain_rows(rng_for(seed, 1), 8, 100, 50)
    b, vb = chains.chain_rows(rng_for(seed, 1), 8, 100, 50)
    assert _same(a, b) and va == vb
    c, _ = chains.chain_rows(rng_for(seed + 1, 1), 8, 100, 50)
    assert c["ts"].shape == a["ts"].shape
    assert np.array_equal(np.sort(c["ts"]), np.sort(a["ts"]))


def test_chain_hints_point_at_their_anchor():
    cols, _ = chains.chain_rows(rng_for(3, 1), 16, 10, 40)
    ap = cols["anchor_pos"]
    inside = ap >= 0
    assert np.array_equal(cols["ts"][ap[inside]], cols["anchor_ts"][inside])
    assert np.all(ap[inside] < np.nonzero(inside)[0])       # causal order
    # the chains' first ops here anchor at counter 10, outside the batch
    assert np.count_nonzero(~inside) == 16
    assert len(np.unique(cols["ts"])) == cols["ts"].size


def test_delta_order_is_permutations():
    o = chains.delta_order(rng_for(5, 3), 8, 40)
    assert all(sorted(o[i:i + 8]) == list(range(8)) for i in range(0, 40, 8))
