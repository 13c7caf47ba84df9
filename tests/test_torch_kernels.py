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

@pytest.mark.parametrize("t,r,c,spread,view", [
    (7, 5, 1, 2, False), (700, 700, 3, 40, False),
    (2050, 2050, 6, 40, False), (2048, 8192, 4, None, False),
    (2050, 2050, 17, 40, False), (1500, 4096, 21, None, False),
    (9, 6, 1, 2, True), (700, 700, 3, 40, True), (2050, 2050, 6, 40, True),
    (2050, 2050, 17, 40, True), (1500, 4096, 21, None, True)],
    ids=["tiny", "local", "ragged", "shuffled", "c17", "c21",
         "view-c1", "view-c3", "view-c6", "view-c17", "view-c21"])
def test_plane_rows_twin_matches_reference(t, r, c, spread, view):
    """C = 1, 3, 4, 6, 17 and 21; ``view``: the plane is a view one row
    into a larger one (as the ops-axis windows are), which starts off a
    16-byte boundary when C is odd."""
    rng = np.random.default_rng(t * 31 + r + c)
    full = rng.integers(-2**63, 2**63 - 1, (r + 1, c), dtype=np.int64)
    plane = full[1:] if view else full[:r]
    idx = rng.permutation(r)[:t].astype(np.int32) if spread is None \
        else _local_idx(rng, t, r, spread)
    arg = _t(full)[1:] if view else _t(plane)
    assert arg.is_contiguous() and arg.storage_offset() == (c if view else 0)
    got = tfr.plane_rows(arg, _t(idx)).numpy()
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


def test_plane_rows_row_plan_matches_the_kernel_source():
    """The plan's constants are csrc/plane_rows.cu's ``#define``s, and a
    plane without columns raises."""
    cu = _cu_defines("plane_rows.cu")
    assert cu["PLANE_ROWS_THREADS"] == tfr.ROWS_THREADS
    assert cu["PLANE_ROWS_PER_THREAD"] == tfr.ROWS_PER_THREAD
    assert cu["PLANE_ROWS_VEC_BYTES"] == tfr.ROWS_VEC_BYTES
    assert tfr.row_plan(2, True) == (cu["PLANE_ROWS_VEC_BYTES"], 1,
                                     cu["PLANE_ROWS_THREADS"],
                                     cu["PLANE_ROWS_PER_THREAD"])
    with pytest.raises(ValueError):
        tfr.row_plan(0, True)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned16",
                                                        "aligned8"])
@pytest.mark.parametrize("c", list(range(1, 22)) + [256, 511, 512, 1000])
def test_plane_rows_row_plan_covers_each_column_once(c, aligned):
    """Kernel 1's plan: the chunks of a row's threads cover every column
    exactly once; the 16-byte access only when C is even and the row is
    aligned; a block holds whole rows and at most its thread count."""
    vec, threads, rows, per = tfr.row_plan(c, aligned)
    assert (vec == 16) == (c % 2 == 0 and aligned)
    assert vec in (8, 16)
    cols_a_chunk = vec // 8
    chunks = c // cols_a_chunk
    assert chunks * cols_a_chunk == c
    # thread x of the row moves chunks x, x + threads, ...
    cover = [col for x in range(threads)
             for j in range(x, chunks, threads)
             for col in range(j * cols_a_chunk, (j + 1) * cols_a_chunk)]
    assert sorted(cover) == list(range(c))
    assert 1 <= threads <= tfr.ROWS_THREADS
    assert threads * rows <= tfr.ROWS_THREADS < threads * (rows + 1)
    assert per == tfr.ROWS_PER_THREAD


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


_TILE = tts.SCAN_TILE


@pytest.mark.parametrize("t,kw,m", [
    (0, 0, 0), (0, 2, 0), (0, 0, 5), (1, 0, 0), (1, 1, 1),
    (_TILE - 1, 1, _TILE - 1), (_TILE, 2, _TILE), (_TILE + 1, 1, 1),
    (2 * 1_000_002, 1, 1_000_002), (2 * 1_000_002, 2, 1_000_002),
    (65_526, 0, 32_763), (2**23 + 1, 0, 0)])
def test_prefix_sums_scan_plan_counts_tiles(t, kw, m):
    """Kernel 3's grid is the flat list of every lane's tiles: ceil(t /
    tile) for the boundary lane and ceil(m / tile) for each weight lane,
    none empty; the scratch holds the tile counter and one status word a
    tile, and nothing when there is nothing to scan."""
    tb, tw, words = tts.scan_plan(t, kw, m)
    assert tb * _TILE >= t > (tb - 1) * _TILE or tb == t == 0
    assert tw * _TILE >= m > (tw - 1) * _TILE or tw == m == 0
    tiles = tb + kw * tw
    assert words == (1 + tiles if tiles else 0)
    # every tile of the flat list holds at least one element of its lane
    lens = [t] * tb + [m] * (kw * tw)
    idx = [j for j in range(tb)] + [j for _ in range(kw) for j in range(tw)]
    assert all(n - j * _TILE >= 1 for n, j in zip(lens, idx))


def _cu_defines(name):
    """The integer ``#define``s of ``csrc/<name>``, evaluated in order."""
    import re
    from pathlib import Path
    src = (Path(tts.__file__).resolve().parent.parent / "csrc"
           / name).read_text()
    env = {}
    for key, expr in re.findall(r"^#define (\w+) ([\w ()*+-]+?)\s*(?://.*)?$",
                                src, re.M):
        try:
            env[key] = int(eval(expr, {}, dict(env)))
        except (NameError, SyntaxError):
            pass
    return env


def test_prefix_sums_scan_plan_matches_the_kernel_source():
    """The Python tile equals csrc/prefix_sums.cu's SCAN_TILE, and a
    negative extent raises."""
    assert _cu_defines("prefix_sums.cu")["SCAN_TILE"] == _TILE
    with pytest.raises(ValueError):
        tts.scan_plan(-1, 0, 0)


@pytest.mark.parametrize("t,m,kw", [
    (0, 0, 0), (1, 1, 0), (1, 1, 1), (_TILE - 1, _TILE, 2),
    (_TILE, _TILE - 1, 1), (_TILE + 1, 3, 2), (2 * _TILE + 3, _TILE + 1, 0)])
def test_prefix_sums_twin_at_tile_edges_matches_reference(t, m, kw):
    """Lengths 0, 1, tile - 1, tile and tile + 1, T != M, Kw = 0, and
    values outside 0/1 that wrap past 2^31: the twin equals the
    reference's ``_lax_prefix`` exactly."""
    rng = np.random.default_rng(t * 3 + m + kw)
    b = rng.integers(-2**31, 2**31 - 1, t, dtype=np.int64).astype(np.int32)
    w = rng.integers(2**29, 2**31 - 1, (kw, m),
                     dtype=np.int64).astype(np.int32)
    got_b, got_w = tts.prefix_sums(_t(b), _t(w))
    want_b, want_w = jts._lax_prefix(jnp.asarray(b), jnp.asarray(w))
    assert got_w.shape == (kw, m)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


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


_I32 = torch.int32


@pytest.mark.parametrize("case", [
    "values_int64", "values_1d", "values_no_rows", "values_no_cols",
    "values_strided", "rid_int64", "rid_2d", "rid_strided"])
def test_monotone_gather_refuses_bad_arguments(case):
    """The wrapper's checks run on every device, so a CPU call refuses
    what the kernel would not take, as a CUDA call does."""
    values = torch.zeros(4, 6, dtype=_I32)
    rid = torch.zeros(5, dtype=_I32)
    if case == "values_int64":
        values = values.long()
    elif case == "values_1d":
        values = values[0]
    elif case == "values_no_rows":
        values = values[:0]
    elif case == "values_no_cols":
        values = values[:, :0].contiguous()
    elif case == "values_strided":
        values = values[:, ::2]
    elif case == "rid_int64":
        rid = rid.long()
    elif case == "rid_2d":
        rid = rid[None]
    else:
        rid = torch.zeros(10, dtype=_I32)[::2]
    kernels.reset_launches()
    with pytest.raises(ValueError):
        tmg.monotone_gather(values, rid)
    assert kernels.launches["monotone_gather"] == 0


@pytest.mark.parametrize("case", [
    "boundary_int64", "boundary_bool", "boundary_2d", "boundary_strided",
    "weights_1d", "weights_int64", "weights_strided"])
def test_prefix_sums_refuses_bad_arguments(case):
    boundary = torch.ones(9, dtype=_I32)
    weights = torch.ones(2, 5, dtype=_I32)
    if case == "boundary_int64":
        boundary = boundary.long()
    elif case == "boundary_bool":
        boundary = boundary.bool()
    elif case == "boundary_2d":
        boundary = boundary[None]
    elif case == "boundary_strided":
        boundary = boundary[::2]
    elif case == "weights_1d":
        weights = weights[0]
    elif case == "weights_int64":
        weights = weights.long()
    else:
        weights = weights.T
    kernels.reset_launches()
    with pytest.raises(ValueError):
        tts.prefix_sums(boundary, weights)
    assert kernels.launches["prefix_sums"] == 0


def test_wrappers_take_views_at_odd_offsets():
    """Contiguous views that start off a 16-byte boundary (the ops-axis
    chunks, T odd) are legal arguments: the twin answers them on the
    CPU, and the kernels take them on the card (tests/test_torch_cuda.py)."""
    base = torch.arange(1, 40, dtype=_I32)
    b = base[1:12]
    w = base[3:3 + 2 * 7].view(2, 7)
    got_b, got_w = tts.prefix_sums(b, w)
    assert torch.equal(got_b, torch.cumsum(b, 0, dtype=_I32))
    assert torch.equal(got_w, torch.cumsum(w, 1, dtype=_I32))
    values = base[5:5 + 3 * 9].view(3, 9)
    rid = torch.remainder(base, 9)[1:8]
    assert torch.equal(tmg.monotone_gather(values, rid),
                       values[:, rid.long()])


@pytest.mark.parametrize("kname", ["prefix_sums", "monotone_gather"])
def test_kerneltime_library_call_and_work_of_kernels_3_and_4(kname):
    """The library call that bench/kerneltime.py times beside kernels 3
    and 4 computes the twin's function on the same inputs, and the work
    it charges them is each input element they need read once and each
    output written once, bound by bytes."""
    from crdt_graph_tpu_torch.bench import kerneltime
    rng = np.random.default_rng(5)
    if kname == "prefix_sums":
        b = torch.from_numpy(rng.integers(0, 2, 37).astype(np.int32))
        w = torch.from_numpy(rng.integers(-5, 9, (2, 23)).astype(np.int32))
        args = (b, w)
        ob, ow = tts.plain_prefix(*args)
        got = kerneltime.library(kname, args)()
        assert torch.equal(got[0], ob) and torch.equal(got[1:, :23], ow)
        nbytes, nops = 8 * (37 + 46), 37 + 46
    else:
        vals = torch.from_numpy(rng.integers(-9, 9, (3, 11)).astype(np.int32))
        rid = torch.from_numpy(np.sort(rng.integers(0, 11, 29))
                               .astype(np.int32))
        args = (vals, rid)
        got = kerneltime.library(kname, args)()
        assert torch.equal(got, tmg.plain_gather(*args))
        used = int(torch.unique(rid).numel())
        nbytes, nops = 4 * 29 + 4 * 3 * used + 4 * 3 * 29, 0
    assert kerneltime.work_of(kname, args) == (nbytes, nops)
    ms, by = kerneltime.bound_ms(nbytes, nops)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / kerneltime.HBM_BYTES_PER_S * 1e3)


@pytest.mark.parametrize("cols", [2, 3])
def test_kerneltime_library_calls_of_kernel_1(cols):
    """Every library call that bench/kerneltime.py times beside kernel 1
    computes the twin's rows on the same inputs (the two-column plane
    also as one 16-byte complex128 element a row)."""
    from crdt_graph_tpu_torch.bench import kerneltime
    rng = np.random.default_rng(cols)
    plane = torch.from_numpy(rng.integers(-2**62, 2**62, (41, cols)))
    idx = torch.from_numpy(rng.integers(0, 41, 97).astype(np.int32))
    want = tfr.plain_rows(plane, idx)
    calls = kerneltime.library_variants("plane_rows", (plane, idx))
    assert ("index_select_rows_as_c128" in calls) == (cols == 2)
    calls["library"] = kerneltime.library("plane_rows", (plane, idx))
    for name, fn in calls.items():
        got = fn()
        if got.dtype == torch.complex128:
            got = got.view(torch.int64).view(-1, cols)
        assert torch.equal(got, want), name
