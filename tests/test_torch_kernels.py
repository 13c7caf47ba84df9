"""The port's kernel wrappers against the JAX reference's kernels.

On the CPU each wrapper runs its plain PyTorch twin, which must equal
the reference's plain version (``_lax_*``, JAX's index clamp included)
and the reference's Pallas kernel run through the interpreter, on inputs
made from a numpy seed: span-violating and out-of-range indices,
negative hops, hop-locality violations, V ∈ {4, 7}, Kw ∈ {1, 2}.  All
integer data, so every comparison is exact.

The CUDA kernels themselves are held against the twins on the card by
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# the suite runs several workers at once: keep PyTorch's CPU ops on one
# thread each so they do not oversubscribe the box
torch.set_num_threads(1)

from crdt_graph_tpu.ops import fused_resolve as jfr  # noqa: E402
from crdt_graph_tpu.ops import mono_gather as jmg  # noqa: E402
from crdt_graph_tpu.ops import tour_scan as jts  # noqa: E402

from crdt_graph_tpu_torch import kernels  # noqa: E402
from crdt_graph_tpu_torch.ops import fused_resolve as tfr  # noqa: E402
from crdt_graph_tpu_torch.ops import mono_gather as tmg  # noqa: E402
from crdt_graph_tpu_torch.ops import tour_scan as tts  # noqa: E402


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _local_idx(rng, t, r, spread):
    """Indices wandering within ``spread`` of a moving base (the span
    the reference's Pallas sweep accepts when ``spread`` is small)."""
    base = np.minimum(np.arange(t, dtype=np.int64) * max(r - 1, 1)
                      // max(t, 1), r - 1)
    return np.clip(base + rng.integers(-spread, spread + 1, t),
                   0, r - 1).astype(np.int32)


def _hop_plane(rng, r, c, hop_col, spread, neg_frac=0.2):
    plane = rng.integers(0, 2**62, (r, c), dtype=np.int64)
    hops = np.clip(np.arange(r) + rng.integers(-spread, spread + 1, r),
                   0, r - 1)
    hops[rng.random(r) < neg_frac] = -1
    plane[:, hop_col] = hops
    return plane


# ---- kernel 1: plane_rows ------------------------------------------------

@pytest.mark.parametrize("t,r,c,spread", [
    (7, 5, 1, 2), (700, 700, 3, 40), (2050, 2050, 6, 40),
    (2048, 8192, 4, None)], ids=["tiny", "local", "ragged", "shuffled"])
def test_plane_rows_twin_matches_reference(t, r, c, spread):
    rng = np.random.default_rng(t * 31 + r)
    plane = rng.integers(-2**63, 2**63 - 1, (r, c), dtype=np.int64)
    idx = rng.permutation(r)[:t].astype(np.int32) if spread is None \
        else _local_idx(rng, t, r, spread)
    got = tfr.plane_rows(_t(plane), _t(idx)).numpy()
    want = np.asarray(jfr._lax_rows(jnp.asarray(plane), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, want)
    # the Pallas kernel takes 0 <= idx < R (and its own fallback when the
    # span fails): the twin equals it too
    pal = np.asarray(jfr.plane_rows(jnp.asarray(plane), jnp.asarray(idx),
                                    interpret=True))
    np.testing.assert_array_equal(got, pal)


def test_plane_rows_out_of_range_indices_clamp_like_jax():
    """Negative indices wrap once, anything still outside clamps — JAX's
    gather rule, which the twin (and the CUDA kernel) reproduce."""
    rng = np.random.default_rng(5)
    r = 300
    plane = rng.integers(0, 2**62, (r, 3), dtype=np.int64)
    idx = np.array([0, r - 1, r, r + 7, 2**31 - 1, -1, -r, -r - 1,
                    -2**31, 5000, -5000], np.int32)
    got = tfr.plane_rows(_t(plane), _t(idx)).numpy()
    want = np.asarray(jfr._lax_rows(jnp.asarray(plane), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, want)


# ---- kernel 2: plane_rows2 -----------------------------------------------

@pytest.mark.parametrize("case", ["local", "hop_far", "span_far", "neg"])
def test_plane_rows2_twin_matches_reference(case):
    rng = np.random.default_rng(len(case))
    r, t, c, hop_col = 4096, 2050, 6, 4
    plane = _hop_plane(rng, r, c, hop_col, spread=30)
    idx = _local_idx(rng, t, r, 40)
    if case == "hop_far":        # hops far outside any 1152-row window
        plane[::97, hop_col] = rng.integers(0, r, plane[::97].shape[0])
    elif case == "span_far":     # first-hop span violated
        idx = rng.permutation(r)[:t].astype(np.int32)
    elif case == "neg":          # mostly negative hops
        plane[rng.random(r) < 0.8, hop_col] = -1
    g, g2 = tfr.plane_rows2(_t(plane), _t(idx), hop_col)
    wg, wg2 = jfr._lax_rows2(jnp.asarray(plane), jnp.asarray(idx), hop_col)
    pg, pg2 = jfr.plane_rows2(jnp.asarray(plane), jnp.asarray(idx),
                              hop_col, interpret=True)
    for got, want, tag in ((g, wg, "hop1"), (g2, wg2, "hop2"),
                           (g, pg, "hop1 pallas"), (g2, pg2, "hop2 pallas")):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=tag)


def test_plane_rows2_hop_beyond_plane_clips():
    """Hops at or past R clip to the last row; negative hops zero."""
    plane = np.arange(40, dtype=np.int64).reshape(8, 5)
    plane[:, 2] = [0, 7, 8, 100, -1, -9, 3, 2**40]
    idx = np.arange(8, dtype=np.int32)[::-1].copy()
    g, g2 = tfr.plane_rows2(_t(plane), _t(idx), 2)
    wg, wg2 = jfr._lax_rows2(jnp.asarray(plane), jnp.asarray(idx), 2)
    np.testing.assert_array_equal(g.numpy(), np.asarray(wg))
    np.testing.assert_array_equal(g2.numpy(), np.asarray(wg2))


# ---- kernel 3: prefix_sums -----------------------------------------------

@pytest.mark.parametrize("m,kw", [(2048, 1), (2048, 2), (5000, 1),
                                  (5000, 2), (33000, 1)])
def test_prefix_sums_twin_matches_reference(m, kw):
    rng = np.random.default_rng(m * 7 + kw)
    b = rng.integers(0, 2, 2 * m).astype(np.int32)
    w = rng.integers(0, 2, (kw, m)).astype(np.int32)
    got_b, got_w = tts.prefix_sums(_t(b), _t(w))
    want_b, want_w = jts._lax_prefix(jnp.asarray(b), jnp.asarray(w))
    pal_b, pal_w = jts.prefix_sums(jnp.asarray(b), jnp.asarray(w),
                                   interpret=True)
    for got, want in ((got_b, want_b), (got_w, want_w),
                      (got_b, pal_b), (got_w, pal_w)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefix_sums_lanes_stay_independent():
    m = 3000
    b = np.ones(2 * m, np.int32)
    w = np.zeros((2, m), np.int32)
    w[0, 0] = 1
    got_b, got_w = tts.prefix_sums(_t(b), _t(w))
    assert int(got_b[-1]) == 2 * m
    assert int(got_w[0, -1]) == 1 and int(got_w[1, -1]) == 0


# ---- kernel 4: monotone_gather -------------------------------------------

@pytest.mark.parametrize("t,v", [(7, 4), (513, 7), (2048, 4), (5000, 7)])
def test_monotone_gather_twin_matches_reference(t, v):
    rng = np.random.default_rng(t + v)
    inc = rng.integers(0, 2, t).astype(np.int32)
    inc[0] = 0
    rid = np.cumsum(inc).astype(np.int32)
    r = int(rid[-1]) + 1
    values = rng.integers(0, 2**23, (v, r), dtype=np.int32)
    got = tmg.monotone_gather(_t(values), _t(rid)).numpy()
    want = np.asarray(jmg._lax_gather(jnp.asarray(values), jnp.asarray(rid)))
    pal = np.asarray(jmg.monotone_gather(jnp.asarray(values),
                                         jnp.asarray(rid), interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pal)


def test_monotone_gather_any_index_clamps_like_jax():
    """The twin takes any rid and any int32 value (no 2^24 guard)."""
    rng = np.random.default_rng(9)
    values = rng.integers(-2**31, 2**31 - 1, (7, 50), dtype=np.int64) \
        .astype(np.int32)
    rid = np.array([0, 49, 50, 99, -1, -50, -51, 3], np.int32)
    got = tmg.monotone_gather(_t(values), _t(rid)).numpy()
    want = np.asarray(jmg._lax_gather(jnp.asarray(values), jnp.asarray(rid)))
    np.testing.assert_array_equal(got, want)


# ---- wrapper dispatch ----------------------------------------------------

def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers run their twins and count no launch;
    the kernel library is never built."""
    kernels.reset_launches()
    plane = torch.arange(12, dtype=torch.int64).reshape(4, 3)
    idx = torch.tensor([3, 0], dtype=torch.int32)
    tfr.plane_rows(plane, idx)
    tfr.plane_rows2(plane, idx, 1)
    tts.prefix_sums(torch.ones(8, dtype=torch.int32),
                    torch.ones(1, 4, dtype=torch.int32))
    tmg.monotone_gather(torch.ones(4, 2, dtype=torch.int32),
                        torch.zeros(3, dtype=torch.int32))
    assert all(v == 0 for v in kernels.launches.values())
    from crdt_graph_tpu_torch.kernels import build
    assert build._lib is None


def test_other_devices_raise():
    meta = torch.empty(4, 3, dtype=torch.int64, device="meta")
    idx = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfr.plane_rows(meta, idx)
    with pytest.raises(ValueError, match="unsupported device"):
        tfr.plane_rows2(meta, idx, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        tts.prefix_sums(idx, idx[None])
    with pytest.raises(ValueError, match="unsupported device"):
        tmg.monotone_gather(idx[None], idx)
