"""The port's ops-axis sharded merge against the JAX package, on the CPU.

``crdt_graph_tpu.parallel.opsaxis.materialize(arrs, k=k)`` runs on the
8-device CPU mesh the root conftest provides; the port's
``opsaxis.materialize(arrs, k=k, device="cpu")`` runs k logical shards in
one process.  Every ``NodeTable`` field must be equal, dtype included
(integer data: tolerance 0).  The ring exchange's twin and the sharded
prefix sums are held against the reference's ``lax.ppermute`` forms
under ``shard_map``; the route gates and an engine session whose bulk
merges take the route are held against the unrouted port.
"""
import random

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

# the suite runs several workers at once: keep PyTorch's CPU ops on one
# thread each so they do not oversubscribe the box
torch.set_num_threads(1)

from crdt_graph_tpu.bench import workloads as jw  # noqa: E402
from crdt_graph_tpu.codec import packed as jpacked  # noqa: E402
from crdt_graph_tpu.ops import tour_scan as jts  # noqa: E402
from crdt_graph_tpu.ops import view as jview  # noqa: E402
from crdt_graph_tpu.parallel import opsaxis as jopsaxis  # noqa: E402
from crdt_graph_tpu.utils import jaxcompat  # noqa: E402

import crdt_graph_tpu_torch as tc  # noqa: E402
from crdt_graph_tpu_torch import convert, engine  # noqa: E402
from crdt_graph_tpu_torch.codec import packed as tpacked  # noqa: E402
from crdt_graph_tpu_torch.ops import merge as tmerge  # noqa: E402
from crdt_graph_tpu_torch.ops import tour_scan as tts  # noqa: E402
from crdt_graph_tpu_torch.parallel import opsaxis  # noqa: E402

OFF = 2 ** 32


@pytest.fixture()
def mesh_of():
    """``mesh_of(k)``: a 1-D ``ops`` mesh over the first k CPU devices
    (the conftest provides 8)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh of tests/conftest.py")
    return lambda k: Mesh(np.asarray(jax.devices()[:k]), (jopsaxis.AXIS,))


def _assert_tables_equal(jt, tt, tag):
    got = convert.table_to_numpy(tt)
    for f in tmerge.FIELDS:
        want = np.asarray(getattr(jt, f))
        assert got[f].dtype == want.dtype, f"{tag} field {f} dtype"
        np.testing.assert_array_equal(got[f], want,
                                      err_msg=f"{tag} field {f}")


# -- the merge, field for field against the reference ----------------------

def _auto_if_deletes(arrs):
    return "exhaustive" if not np.any(
        arrs["kind"] == jpacked.KIND_DELETE) else "auto"


# the reduced config 1-8 shapes of tests/test_opsaxis.py, the mixed
# deletes batch, the 2001-row batch no k > 1 divides, and the deep-paths
# batch whose parent rows straddle the halo window at k = 8
SHAPES = {
    "config1": lambda: jpacked.pack(jw.editor_replay(1000)).arrays(),
    "config2": lambda: jpacked.pack(jw.two_replica_interleaved(2000)).arrays(),
    "config3": lambda: jpacked.pack(jw.nested_tree(6000)).arrays(),
    "config4": lambda: jpacked.pack(jw.tombstone_heavy(4000)).arrays(),
    "config5": lambda: jw.chain_workload(16, 8192),
    "config6": lambda: jw.descending_chains(128, 8192),
    "config7": lambda: jw.comb_pairs(8192),
    "config8": lambda: jw.deep_paths(16, 8192, max_depth=16),
    "deletes": lambda: jw.chain_with_deletes(8192, 8),
    "pad2001": lambda: jw.chain_workload(3, 3 * 667),
    "halo": lambda: jw.deep_paths(16, 4096, max_depth=16),
}
HINTS = {"deletes": None}
_REFERENCE = {}


def _reference_table(shape, arrs, k, hints):
    """The JAX ``opsaxis.materialize(arrs, k=k)`` table.  Every k that
    pads the batch to the same length gives the reference the same table
    (its own suite, tests/test_opsaxis.py, pins that), so each padded
    length is traced once here and shared by the k's that reach it: the
    reference's shard_map trace is nearly all of this file's time."""
    key = (shape, -(-arrs["kind"].shape[0] // k) * k)
    if key not in _REFERENCE:
        _REFERENCE[key] = jview.to_host(
            jopsaxis.materialize(arrs, k=k, hints=hints))
    return _REFERENCE[key]


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_opsaxis_matches_reference(shape, k, mesh_of):
    arrs = SHAPES[shape]()
    hints = HINTS.get(shape, _auto_if_deletes(arrs))
    jt = _reference_table(shape, arrs, k, hints)
    f0 = opsaxis.halo_fallbacks
    tt = opsaxis.materialize(arrs, k=k, hints=hints, device="cpu")
    _assert_tables_equal(jt, tt, f"{shape} k={k}")
    if shape == "halo" and k == 8:
        # the straddle really exists (tests/test_opsaxis.py) and took the
        # single-device gather
        assert 15 < 7 * -(-(4096 + 2) // 8) - opsaxis.HALO
        assert opsaxis.halo_fallbacks > f0
    if shape == "config5":
        seq = np.asarray(tt.ts)[np.asarray(tt.visible_order)][
            :int(tt.num_visible)]
        np.testing.assert_array_equal(seq, jw.chain_expected_ts(16, 8192))


@pytest.mark.parametrize("shape", ["config2", "config4", "config6"])
def test_compact_sibling_tier_matches_reference(shape, monkeypatch, mesh_of,
                                                request):
    """Below the default sort widths the compact sibling branch runs, and
    with it the sharded crowd count (``frame_add``, ``cumsum``), the
    singleton overlay (``frame_set``) and, on the one-group shapes, the
    running max (``cummax``)."""
    for name, v in (("GRAFT_S_CAP", 64), ("GRAFT_S_CAP2", 16),
                    ("GRAFT_R_CAP", 256), ("GRAFT_R_CAP2", 16)):
        monkeypatch.setenv(name, str(v))
    jax.clear_caches()
    request.addfinalizer(jax.clear_caches)
    arrs = SHAPES[shape]()
    hints = _auto_if_deletes(arrs)
    jt = jview.to_host(jopsaxis.materialize(arrs, k=8, hints=hints))
    tt = opsaxis.materialize(arrs, k=8, hints=hints, device="cpu")
    _assert_tables_equal(jt, tt, f"{shape} compact")


def test_unknown_hints_mode_raises():
    with pytest.raises(ValueError, match="unknown hints mode"):
        opsaxis.materialize(jw.chain_workload(2, 64), k=2, hints="AUTO",
                            device="cpu")


# -- the windowed plane gather ---------------------------------------------

def test_windowed_plane_rows_near_and_far():
    """A near-diagonal index takes the windowed leg, a straddling index
    the counted single-device fallback; both equal ``plane[idx]``."""
    r = 4096
    plane = torch.arange(r * 3, dtype=torch.int64).reshape(r, 3)
    near = torch.clamp(torch.arange(r, dtype=torch.int32) - 1, 0, r - 1)
    far = torch.from_numpy(
        np.random.default_rng(7).integers(0, r, r).astype(np.int32))
    part = opsaxis.OpsAxisPart(8)
    f0 = opsaxis.halo_fallbacks
    assert torch.equal(part.plane_rows(plane, near), plane[near.long()])
    assert opsaxis.halo_fallbacks == f0
    assert torch.equal(part.plane_rows(plane, far), plane[far.long()])
    assert opsaxis.halo_fallbacks == f0 + 1


# -- the scan core ---------------------------------------------------------

@pytest.mark.parametrize("m", [16, 100, 1000, 4097])
def test_sharded_prefix_sums_match_reference(m, mesh_of):
    rng = np.random.default_rng(m)
    b = rng.integers(0, 2, 2 * m).astype(np.int32)
    w = rng.integers(0, 2, (2, m)).astype(np.int32)

    def body(_):
        return jts.sharded_prefix_sums(jnp.asarray(b), jnp.asarray(w),
                                       axis=jopsaxis.AXIS, k=8)

    fn = jaxcompat.shard_map(body, mesh=mesh_of(8),
                             in_specs=(P(jopsaxis.AXIS),),
                             out_specs=(P(), P()), check_vma=False)
    jb, jwl = jax.jit(fn)(jnp.zeros(8, jnp.int32))
    tb, twl = tts.sharded_prefix_sums(torch.from_numpy(b),
                                      torch.from_numpy(w),
                                      opsaxis.OpsAxisPart(8))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(twl.numpy(), np.asarray(jwl))
    np.testing.assert_array_equal(tb.numpy(), np.cumsum(b))


def _ring_cases():
    rng = np.random.default_rng(3)
    big = np.full((8, 5), 2**31 - 7, np.int64)
    return {
        "add": (rng.integers(-2**31, 2**31 - 1, (8, 5), dtype=np.int64),
                "add"),
        "add_wraps": (big, "add"),
        "max_biased": (rng.integers(1, 1000, (8, 5)), "max"),
        "max_negative": (rng.integers(-50, 20, (8, 1)), "max"),
    }


@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("case", list(_ring_cases()))
def test_plain_ring_exclusive_matches_reference(case, k, mesh_of):
    vals, op = _ring_cases()[case]
    vals = vals[:k].astype(np.int32)

    def body(v):
        return jts.ring_exclusive(v[0], jopsaxis.AXIS, k, op=op)[None]

    fn = jaxcompat.shard_map(body, mesh=mesh_of(k),
                             in_specs=(P(jopsaxis.AXIS),),
                             out_specs=P(jopsaxis.AXIS), check_vma=False)
    want = np.asarray(jax.jit(fn)(jnp.asarray(vals)))
    got = tts.plain_ring_exclusive([torch.from_numpy(v) for v in vals], op)
    np.testing.assert_array_equal(torch.stack(got).numpy(), want)
    # on CPU tensors the wrapper is the twin
    got2 = tts.ring_exclusive([torch.from_numpy(v) for v in vals], op)
    np.testing.assert_array_equal(torch.stack(got2).numpy(), want)


def test_plain_ring_exclusive_matches_pallas_interpret(mesh_of):
    """Against the reference's Pallas ring (kernel 5's TPU form) in
    interpret mode, where the installed JAX can interpret remote DMA
    under shard_map; skipped visibly where it cannot, as
    tests/test_opsaxis.py does."""
    if not jts.HAVE_PALLAS:
        pytest.skip("pallas unavailable")
    vals = np.arange(8, dtype=np.int32) + 1

    def body(v):
        return jts.ring_exclusive_pallas(v, 8, interpret=True)

    fn = jaxcompat.shard_map(body, mesh=mesh_of(8),
                             in_specs=(P(jopsaxis.AXIS),),
                             out_specs=P(jopsaxis.AXIS), check_vma=False)
    try:
        want = np.asarray(jax.jit(fn)(jnp.asarray(vals)))
    except Exception as e:  # noqa: BLE001 — interpret-mode remote DMA
        pytest.skip(f"installed pallas cannot interpret remote DMA under "
                    f"shard_map: {type(e).__name__}")
    got = tts.plain_ring_exclusive([torch.from_numpy(vals[i:i + 1])
                                    for i in range(8)])
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


def test_ring_exclusive_edges():
    one = tts.ring_exclusive([torch.tensor([5, -3], dtype=torch.int32)])
    assert one[0].tolist() == [0, 0]
    assert tts.ring_exclusive([]) == []
    with pytest.raises(ValueError, match="unknown ring op"):
        tts.ring_exclusive([torch.zeros(1, dtype=torch.int32)], "min")


# -- the route -------------------------------------------------------------

def test_route_gates(monkeypatch):
    monkeypatch.setattr(opsaxis, "mesh_devices", lambda: 8)
    # off unless asked for, even with eight cards (the port's default)
    monkeypatch.delenv("GRAFT_OPSAXIS", raising=False)
    assert not opsaxis.enabled_for(1 << 20)
    assert not opsaxis.stats()["enabled"]
    monkeypatch.setenv("GRAFT_OPSAXIS", "0")
    assert not opsaxis.enabled_for(1 << 20)
    monkeypatch.setenv("GRAFT_OPSAXIS", "1")
    monkeypatch.setenv("GRAFT_OPSAXIS_MIN_OPS", "1024")
    assert not opsaxis.enabled_for(512)          # below the threshold
    assert not opsaxis.enabled_for(1025)         # not divisible
    assert opsaxis.enabled_for(2048)
    monkeypatch.delenv("GRAFT_OPSAXIS_MIN_OPS")
    assert not opsaxis.enabled_for(2048)
    assert opsaxis.enabled_for(1 << 18)
    st = opsaxis.stats()
    assert st["enabled"] and st["min_ops"] == 1 << 18
    assert st["halo_rows"] == opsaxis.HALO == 1152 + 2 * 1152
    assert {"merges", "devices", "routed_ops"} <= set(st)
    monkeypatch.undo()
    # one device or none: the route is off, as in the reference
    if not torch.cuda.is_available():
        assert opsaxis.mesh_devices() == 1
    if opsaxis.mesh_devices() < 2:
        assert not opsaxis.enabled_for(1 << 20)


def _chain(r, n, start=1, anchor=0):
    ops, prev = [], anchor
    for c in range(start, start + n):
        ops.append(tc.Add(r * OFF + c, (prev,), f"{r}:{c}"))
        prev = r * OFF + c
    return ops


def _session(routed, monkeypatch):
    """Bulk merges of one replica: a causal 1,200-op delta, a shuffled
    one the host apply cannot take, and a packed chunked apply that
    rolls a chunk back; the state after each step."""
    monkeypatch.setenv("GRAFT_OPSAXIS", "1" if routed else "0")
    monkeypatch.setenv("GRAFT_OPSAXIS_MIN_OPS", "1")
    monkeypatch.setattr(opsaxis, "mesh_devices", lambda: 8)
    before = opsaxis.stats()["merges"]
    t = tc.init(3, device="cpu")
    t.add("seed")
    steps = []
    more = _chain(5, 1200, anchor=0)
    shuffled = _chain(6, 700, anchor=5 * OFF + 600)
    random.Random(1).shuffle(shuffled)
    rev = _chain(7, 1200)
    for step in (lambda: t.apply(tc.Batch(tuple(more))),
                 lambda: t.apply(tc.Batch(tuple(shuffled))),
                 lambda: t.apply_packed_chunked(
                     tpacked.pack(rev[600:] + rev[:600]), 512)):
        step()
        tab = t.table()
        p = t.packed_state()
        steps.append({
            "table": {f: np.asarray(getattr(tab, f)) for f in tmerge.FIELDS},
            "mask": np.asarray(t.last_applied_mask),
            "values": t.visible_values(),
            "windows": [engine.packed_since_window(p, s, 256)[0]
                        for s in (0, 5 * OFF + 1, 6 * OFF + 3, 7 * OFF + 900)],
        })
    return steps, opsaxis.stats()["merges"] - before


def test_engine_session_routed_equals_unrouted(monkeypatch):
    on, routed = _session(True, monkeypatch)
    off, unrouted = _session(False, monkeypatch)
    assert routed >= 3 and unrouted == 0
    for a, b in zip(on, off):
        for f in tmerge.FIELDS:
            np.testing.assert_array_equal(a["table"][f], b["table"][f], f)
        np.testing.assert_array_equal(a["mask"], b["mask"])
        assert a["values"] == b["values"]
        assert a["windows"] == b["windows"]
