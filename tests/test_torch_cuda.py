"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: each test needs a CUDA device and skips without one
(the kernels have no CPU mode).  This file imports no JAX, so it runs on
a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from crdt_graph_tpu_torch import kernels
from crdt_graph_tpu_torch.ops import fused_resolve as tfr
from crdt_graph_tpu_torch.ops import mono_gather as tmg
from crdt_graph_tpu_torch.ops import tour_scan as tts


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _hop_plane(rng, r, c, hop_col, spread, neg_frac=0.2):
    plane = rng.integers(0, 2**62, (r, c), dtype=np.int64)
    hops = np.clip(np.arange(r) + rng.integers(-spread, spread + 1, r),
                   0, r - 1)
    hops[rng.random(r) < neg_frac] = -1
    plane[:, hop_col] = hops
    return plane


def _vouched(arrs, n):
    """A vouched ``PackedOps`` over config-5 arrays whose values are the
    row numbers."""
    from crdt_graph_tpu_torch.codec import packed
    return packed.PackedOps(
        kind=arrs["kind"], ts=arrs["ts"], parent_ts=arrs["parent_ts"],
        anchor_ts=arrs["anchor_ts"], depth=arrs["depth"],
        paths=arrs["paths"], value_ref=arrs["value_ref"], pos=arrs["pos"],
        values=list(range(n)), num_ops=n, parent_pos=arrs["parent_pos"],
        anchor_pos=arrs["anchor_pos"], target_pos=arrs["target_pos"],
        ts_rank=arrs["ts_rank"], hints_vouched=True)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_equal_twins(cuda):
    rng = np.random.default_rng(0)
    r, c, hop_col = 100_003, 6, 4
    plane = _hop_plane(rng, r, c, hop_col, spread=5000)
    idx = np.concatenate([rng.permutation(r).astype(np.int32),
                          np.array([-1, -r, r, 2**31 - 1], np.int32)])
    pc, ic = _t(plane).to(cuda), _t(idx).to(cuda)
    kernels.reset_launches()
    np.testing.assert_array_equal(tfr.plane_rows(pc, ic).cpu().numpy(),
                                  tfr.plain_rows(_t(plane), _t(idx)).numpy())
    got = tfr.plane_rows2(pc, ic, hop_col)
    want = tfr.plain_rows2(_t(plane), _t(idx), hop_col)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    for kw in (1, 2):
        b = rng.integers(0, 2, 2 * r + 1).astype(np.int32)
        w = rng.integers(0, 2, (kw, r)).astype(np.int32)
        gb, gw = tts.prefix_sums(_t(b).to(cuda), _t(w).to(cuda))
        wb, ww = tts.plain_prefix(_t(b), _t(w))
        np.testing.assert_array_equal(gb.cpu().numpy(), wb.numpy())
        np.testing.assert_array_equal(gw.cpu().numpy(), ww.numpy())
    for v in (4, 7):
        rid = np.cumsum(rng.integers(0, 2, r)).astype(np.int32)
        vals = rng.integers(-2**31, 2**31 - 1, (v, int(rid[-1]) + 1),
                            dtype=np.int64).astype(np.int32)
        got = tmg.monotone_gather(_t(vals).to(cuda), _t(rid).to(cuda))
        np.testing.assert_array_equal(
            got.cpu().numpy(), tmg.plain_gather(_t(vals), _t(rid)).numpy())
    torch.cuda.synchronize()
    assert kernels.launches == {"plane_rows": 1, "plane_rows2": 1,
                                "prefix_sums": 2, "monotone_gather": 2,
                                "ring_exclusive": 0,
                                "plane_rows_batched": 0,
                                "plane_rows2_batched": 0,
                                "prefix_sums_batched": 0,
                                "monotone_gather_batched": 0}


@pytest.mark.cuda
def test_cuda_ring_exclusive_equals_twin(cuda):
    """Kernel 5 against its twin: add (wrapping like int32) and max (the
    zero start clamps negative carries), k = 1 to the 64-shard cap, L = 1
    to a multi-block lane count."""
    rng = np.random.default_rng(1)
    kernels.reset_launches()
    n = 0
    for k in (1, 2, 8, 64):
        for lanes in (1, 5, 300):
            for op, lo, hi in (("add", -2**31, 2**31 - 1), ("max", -50, 20),
                               ("max", 1, 1000)):
                vals = rng.integers(lo, hi, (k, lanes),
                                    dtype=np.int64).astype(np.int32)
                got = tts.ring_exclusive(
                    [_t(v).to(cuda) for v in vals], op)
                want = tts.plain_ring_exclusive([_t(v) for v in vals], op)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
                n += 1
    torch.cuda.synchronize()
    assert kernels.launches["ring_exclusive"] == n
    with pytest.raises(ValueError):
        tts.ring_exclusive([torch.zeros(2, dtype=torch.int32, device=cuda)]
                           * 65)


@pytest.mark.cuda
def test_cuda_opsaxis_merge_equals_single_device(cuda):
    """The ops-axis sharded merge at k = 8 logical shards on the card
    equals the single-device merge field for field, and its scans went
    through kernel 5."""
    from crdt_graph_tpu_torch import convert
    from crdt_graph_tpu_torch.bench import workloads
    from crdt_graph_tpu_torch.ops import merge
    from crdt_graph_tpu_torch.parallel import opsaxis
    for arrs, hints in ((workloads.chain_workload(64, 65_536), "exhaustive"),
                        (workloads.chain_with_deletes(65_536, 16, 64),
                         None)):
        want = convert.table_to_numpy(merge.materialize(arrs, hints=hints,
                                                        device=cuda))
        kernels.reset_launches()
        got = convert.table_to_numpy(opsaxis.materialize(
            arrs, k=8, hints=hints, device=cuda))
        torch.cuda.synchronize()
        assert kernels.launches["ring_exclusive"] >= 1
        for f in merge.FIELDS:
            np.testing.assert_array_equal(got[f], want[f], f)


@pytest.mark.cuda
@pytest.mark.parametrize("c", range(1, 22))
def test_cuda_plane_rows_widths_views_and_edges(cuda, c):
    """Kernel 1 equals its twin at width C on a 16-byte-aligned plane, on
    a view one row in (8-byte aligned when C is odd) and on a view one
    element in (8-byte aligned at every C), at T = 0, 1 and ragged, with
    indices at -2^31, -R-5, R+99 and 2^31-1, and with the index a view at
    an odd 4-byte offset; one launch a call with T > 0, none at T = 0."""
    rng = np.random.default_rng(c)
    r = 5003
    base = _t(rng.integers(-2**63, 2**63 - 1, (r + 2) * c,
                           dtype=np.int64)).to(cuda)
    idx = rng.integers(0, r, 2 * 1024 + 7).astype(np.int32)
    idx[1:7] = [-2**31, -r - 5, r + 99, 2**31 - 1, -1, -r]
    ic = _t(idx).to(cuda)
    kernels.reset_launches()
    n = 0
    for lo in (0, c, 1):
        plane = base[lo:lo + r * c].view(r, c)
        assert plane.is_contiguous()
        for i in (ic[1:1], ic[1:2], ic[3:4], ic[:-2], ic[1:]):
            got = tfr.plane_rows(plane, i)
            want = tfr.plain_rows(plane.cpu(), i.cpu())
            np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(),
                                          err_msg=f"lo={lo} T={len(i)}")
            n += len(i) > 0
    torch.cuda.synchronize()
    assert kernels.launches["plane_rows"] == n
    assert sum(kernels.launches.values()) == n


@pytest.mark.cuda
def test_cuda_plane_rows_plan_equals_the_c_entry_point(cuda):
    """``fused_resolve.row_plan`` is the launch geometry crdt_plane_rows
    chooses, at every width up to past one block a row, both alignments."""
    import ctypes
    from crdt_graph_tpu_torch.kernels import build
    lib = build.load()
    plan = (ctypes.c_int * 4)()
    for c in range(1, 1100):
        for aligned in (True, False):
            build.check(lib.crdt_plane_rows_plan(
                c, int(aligned), ctypes.cast(plan, ctypes.c_void_p)),
                "crdt_plane_rows_plan")
            assert tuple(plan) == tfr.row_plan(c, aligned), (c, aligned)


@pytest.mark.cuda
def test_cuda_plane_rows_past_2_to_the_31_rows(cuda):
    """A plane of 2^31 + 5 rows takes kernel 1's 64-bit index clamp: each
    index reads the row JAX's rule names."""
    r = 2**31 + 5
    if torch.cuda.mem_get_info()[0] < 8 * r + (4 << 30):
        pytest.skip("needs ~20 GB of free device memory")
    plane = torch.empty((r, 1), dtype=torch.int64, device=cuda)
    idx = [0, 7, 2**31 - 1, -1, -2, -2**31, -5]
    rows = [i + r if i < 0 else i for i in idx]
    plane[torch.tensor(rows, device=cuda), 0] = torch.tensor(
        [1000 + j for j in range(len(rows))], device=cuda)
    kernels.reset_launches()
    got = tfr.plane_rows(plane, torch.tensor(idx, dtype=torch.int32,
                                             device=cuda))
    want = plane[torch.tensor(rows, device=cuda)]
    assert torch.equal(got, want)
    assert kernels.launches["plane_rows"] == 1
    del plane
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_inputs(cuda):
    plane = torch.zeros(4, 3, dtype=torch.int32, device=cuda)
    idx = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tfr.plane_rows(plane, idx)
    with pytest.raises(ValueError):
        tmg.monotone_gather(idx[None].to(torch.int64), idx)


@pytest.mark.cuda
def test_cuda_engine_bootstrap_counts_launches(cuda):
    """A replica bootstraps a 65,536-op config-5 batch on the card
    (vouched: the fused exhaustive leg), reads back in closed-form order,
    and the launches show the merge went through kernels 2-4; an
    older-format restore of it takes the sort+join on the card through
    kernel 1."""
    import io
    import json
    from crdt_graph_tpu_torch import engine
    from crdt_graph_tpu_torch.bench import workloads
    from crdt_graph_tpu_torch.codec import packed
    from crdt_graph_tpu_torch.ops import merge
    n = 65_536
    arrs = workloads.chain_workload(64, n)
    p = packed.PackedOps(
        kind=arrs["kind"], ts=arrs["ts"], parent_ts=arrs["parent_ts"],
        anchor_ts=arrs["anchor_ts"], depth=arrs["depth"],
        paths=arrs["paths"], value_ref=arrs["value_ref"], pos=arrs["pos"],
        values=list(range(n)), num_ops=n, parent_pos=arrs["parent_pos"],
        anchor_pos=arrs["anchor_pos"], target_pos=arrs["target_pos"],
        ts_rank=arrs["ts_rank"], hints_vouched=True)
    kernels.reset_launches()
    t = engine.init(1, device=cuda)
    t.apply_packed(p)
    torch.cuda.synchronize()
    assert kernels.launches["plane_rows2"] == 1
    assert kernels.launches["prefix_sums"] == 1
    assert kernels.launches["monotone_gather"] == 1
    got = arrs["ts"][np.asarray(t.visible_values())]
    np.testing.assert_array_equal(got, workloads.chain_expected_ts(64, n))
    buf = io.BytesIO()
    t.checkpoint_packed(buf, compress=False)
    z = np.load(io.BytesIO(buf.getvalue()))
    meta = json.loads(bytes(z["meta"]).decode())
    meta.pop("hints_vouched")
    old = {k: z[k] for k in z.files
           if k not in ("parent_pos", "anchor_pos", "target_pos", "ts_rank",
                        "meta")}
    old["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    out = io.BytesIO()
    np.savez(out, **old)
    out.seek(0)
    kernels.reset_launches()
    merge.fallbacks = 0
    r = engine.TpuTree.restore_packed(out, device=cuda)
    assert r.visible_values() == t.visible_values()
    assert merge.fallbacks == 1
    assert kernels.launches["plane_rows"] == 2


@pytest.mark.cuda
def test_cuda_durable_recovery_merges_on_the_card(cuda, tmp_path):
    """A durable tiered replica on the card (native ingest, WAL,
    ``checkpoint_tiered``) crashes mid-spill; ``restore_tiered`` on the
    card plus the WAL replay equals the never-crashed replica, and the
    recovery's first full merge goes through kernels 2-4."""
    import os
    from crdt_graph_tpu_torch import engine, native, wal
    from crdt_graph_tpu_torch.bench import workloads
    from crdt_graph_tpu_torch.codec import packed
    from crdt_graph_tpu_torch.core.operation import Add
    n, chunk = 65_536, 8_192
    arrs = workloads.chain_workload(64, n)
    p = packed.PackedOps(
        kind=arrs["kind"], ts=arrs["ts"], parent_ts=arrs["parent_ts"],
        anchor_ts=arrs["anchor_ts"], depth=arrs["depth"],
        paths=arrs["paths"], value_ref=arrs["value_ref"], pos=arrs["pos"],
        values=list(range(n)), num_ops=n, parent_pos=arrs["parent_pos"],
        anchor_pos=arrs["anchor_pos"], target_pos=arrs["target_pos"],
        ts_rank=arrs["ts_rank"], hints_vouched=True)
    assert native.available(), native._build_error
    bodies = [native.encode_pack(packed.select_rows(
        p, np.arange(s, min(s + chunk, n)))) for s in range(0, n, chunk)]
    d = tmp_path / "doc"
    t = engine.init(1, device=cuda)
    t.enable_log_tiering(str(d), hot_ops=2048, durable=True)
    t._log.set_durable_hooks(t.manifest_meta, None)
    w = wal.Wal(str(d / "wal.log"))
    for k, body in enumerate(bodies):
        n0 = t.log_length
        t.apply_wire(body)
        w.append(t.log_view().slice_packed(n0, t.log_length), t.log_length)
        w.sync()
        if k == 3:
            t.checkpoint_tiered(str(d), write_matz=False)
    os.environ["GRAFT_CRASH_POINT"] = "mid-spill"
    try:
        with pytest.raises(wal.CrashPoint):
            t.apply_wire(native.encode_pack(packed.pack([
                Add(99 * 2**32 + c, ((99 * 2**32 + c - 1)
                                     if c > 1 else 0,), c)
                for c in range(1, 4097)])))
    finally:
        del os.environ["GRAFT_CRASH_POINT"]
    w.close()
    kernels.reset_launches()
    r = engine.TpuTree.restore_tiered(str(d), device=cuda)
    wal.Wal(str(d / "wal.log")).replay_into(r, 1 << 17)
    r.table()
    torch.cuda.synchronize()
    for k in ("plane_rows2", "prefix_sums", "monotone_gather"):
        assert kernels.launches[k] >= 1, kernels.launches
    got = arrs["ts"][np.asarray(r.visible_values())]
    np.testing.assert_array_equal(got, workloads.chain_expected_ts(64, n))
    assert r.log_length == n and r.device.type == "cuda"


@pytest.mark.cuda
def test_cuda_opsaxis_shards_on_distinct_cards(cuda, monkeypatch):
    """With two or more cards the sharded merge puts its shards on
    distinct cards (kernel 5 reaches them by peer access) and equals the
    single-device merge; with the route asked for, the engine's bulk
    merge then takes it.  Skips on a one-card machine."""
    from crdt_graph_tpu_torch import convert, engine
    from crdt_graph_tpu_torch.bench import workloads
    from crdt_graph_tpu_torch.ops import merge
    from crdt_graph_tpu_torch.parallel import opsaxis
    if opsaxis.mesh_devices() < 2:
        pytest.skip("needs two or more CUDA devices")
    k = opsaxis.mesh_devices()
    arrs = workloads.chain_workload(64, 65_536)
    want = convert.table_to_numpy(merge.materialize(arrs, hints="exhaustive",
                                                    device=cuda))
    kernels.reset_launches()
    got = convert.table_to_numpy(opsaxis.materialize(arrs, hints="exhaustive",
                                                     device=cuda))
    torch.cuda.synchronize()
    assert kernels.launches["ring_exclusive"] >= 1
    assert opsaxis.stats()["devices"] == k
    for f in merge.FIELDS:
        np.testing.assert_array_equal(got[f], want[f], f)
    monkeypatch.setenv("GRAFT_OPSAXIS_MIN_OPS", "1024")
    monkeypatch.delenv("GRAFT_OPSAXIS", raising=False)
    assert not opsaxis.enabled_for(65_536)       # off unless asked for
    monkeypatch.setenv("GRAFT_OPSAXIS", "1")
    assert opsaxis.enabled_for(65_536)
    p = _vouched(arrs, 65_536)
    before = opsaxis.stats()["merges"]
    kernels.reset_launches()
    t = engine.init(1, device=cuda)
    t.apply_packed(p)
    torch.cuda.synchronize()
    assert opsaxis.stats()["merges"] == before + 1
    assert kernels.launches["ring_exclusive"] >= 1
    assert kernels.launches["plane_rows2"] == 0
    got = arrs["ts"][np.asarray(t.visible_values())]
    np.testing.assert_array_equal(got, workloads.chain_expected_ts(64, 65_536))


# ---- kernel 4 and kernel 3 (the look-back scan) at their edges ----------

# tokens per block of csrc/mono_gather.cu and of its staged variant
# (csrc/variants/mono_gather_staged.cu)
MG_TILES = (1024, 2048)


def _at_offset(x, off, dev):
    """``x`` (numpy int32) as a contiguous view that starts ``off``
    elements into a larger buffer on ``dev`` (off the 16-byte boundary
    for odd ``off``)."""
    flat = torch.zeros(x.size + off + 3, dtype=torch.int32, device=dev)
    flat[off:off + x.size] = _t(x.ravel()).to(dev)
    return flat[off:off + x.size].view(x.shape)


def _rid(rng, kind, t):
    """A run-id stream of ``kind``: the merge's (steps 0/1), long single
    runs (a block reads one column), all distinct, steps up to 2,
    decreasing runs, and wild indices (negative, out of range): the last
    three break the merge's monotone contract, which the kernel does not
    rely on."""
    if kind == "steps01":
        inc = rng.integers(0, 2, t)
        inc[0] = 0
        rid = np.cumsum(inc)
    elif kind == "one_run":
        rid = np.arange(t) // 5000
    elif kind == "distinct":
        rid = np.arange(t)
    elif kind == "steps2":
        rid = np.cumsum(rng.integers(0, 3, t))
    elif kind == "decreasing":
        rid = (np.arange(t) % 3001)[::-1] // 2
    else:
        rid = rng.integers(-3 * t - 9, 3 * t + 9, t)
        rid[:4] = [-1, -2**31, 2**31 - 1, t][:min(4, t)]
    return np.clip(rid, 0, None).astype(np.int32) if kind != "wild" \
        else rid.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("v", [1, 4, 7, 9])
@pytest.mark.parametrize("kind", ["steps01", "one_run", "distinct", "steps2",
                                  "decreasing", "wild"])
def test_cuda_monotone_gather_windows_and_escapes(cuda, v, kind):
    """Kernel 4 equals its twin bit for bit: tokens on and across block
    edges, every kind of ``rid``, V in {1, 4, 7, 9} (the generic
    instantiation at 9), ``rid`` and ``values`` as views at odd offsets
    and T odd."""
    rng = np.random.default_rng(v * 17 + len(kind))
    kernels.reset_launches()
    calls = 0
    edges = [e + d for e in MG_TILES for d in (-1, 0, 1)]
    for t in (1, *edges, 3 * MG_TILES[0] + 1, 20_011):
        rid = _rid(rng, kind, t)
        r = max(int(rid.max()) + 1, 1) if kind != "wild" else t // 2 + 1
        vals = rng.integers(-2**31, 2**31 - 1, (v, r),
                            dtype=np.int64).astype(np.int32)
        want = tmg.plain_gather(_t(vals), _t(rid)).numpy()
        for off_v, off_r in ((0, 0), (1, 3), (2, 1), (3, 2)):
            got = tmg.monotone_gather(_at_offset(vals, off_v, cuda),
                                      _at_offset(rid, off_r, cuda))
            calls += 1
            np.testing.assert_array_equal(got.cpu().numpy(), want,
                                          f"t={t} offsets={off_v, off_r}")
    torch.cuda.synchronize()
    assert kernels.launches["monotone_gather"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [0, 1, 2])
def test_cuda_prefix_sums_lookback_edges(cuda, kw):
    """Kernel 3 equals its twin bit for bit at lengths 0, 1, tile - 1,
    tile and tile + 1 with T != M, at the sharded chunk lengths, with
    values outside 0/1 that wrap past 2^31, and with both operands as
    views at odd offsets (weight rows off 16-byte boundaries)."""
    tile = tts.SCAN_TILE
    rng = np.random.default_rng(kw)
    lengths = (0, 1, tile - 1, tile, tile + 1)
    cases = [(t, m) for t in lengths for m in lengths if t != m]
    cases += [(65_526, 32_763), (2 * 125_001, 125_001), (500_001, 500_001)]
    kernels.reset_launches()
    calls = 0
    for t, m in cases:
        b = rng.integers(-2**31, 2**31 - 1, t, dtype=np.int64).astype(np.int32)
        w = rng.integers(2**29, 2**31 - 1, (kw, m),
                         dtype=np.int64).astype(np.int32)
        wb, ww = tts.plain_prefix(_t(b), _t(w))
        for off_b, off_w in ((0, 0), (1, 2), (3, 1)):
            gb, gw = tts.prefix_sums(_at_offset(b, off_b, cuda),
                                     _at_offset(w, off_w, cuda))
            calls += tts.scan_plan(t, kw, m)[2] > 0
            np.testing.assert_array_equal(gb.cpu().numpy(), wb.numpy(),
                                          f"boundary t={t} m={m}")
            np.testing.assert_array_equal(gw.cpu().numpy(), ww.numpy(),
                                          f"weights t={t} m={m}")
    torch.cuda.synchronize()
    assert kernels.launches["prefix_sums"] == calls


@pytest.mark.cuda
def test_cuda_prefix_sums_long_lookback_chain(cuda):
    """One lane of 2^23 + 1 elements: a look-back chain of 2,049 tiles,
    beside two weight lanes of another length."""
    rng = np.random.default_rng(23)
    t, m = 2**23 + 1, 2**22 + 3
    b = rng.integers(-5, 9, t).astype(np.int32)
    w = rng.integers(0, 2**31 - 1, (2, m), dtype=np.int64).astype(np.int32)
    gb, gw = tts.prefix_sums(_t(b).to(cuda), _t(w).to(cuda))
    wb, ww = tts.plain_prefix(_t(b), _t(w))
    np.testing.assert_array_equal(gb.cpu().numpy(), wb.numpy())
    np.testing.assert_array_equal(gw.cpu().numpy(), ww.numpy())


@pytest.mark.cuda
def test_cuda_prefix_sums_repeated_on_one_stream(cuda):
    """100 calls back to back on one stream, alternating two inputs and
    freeing each result, so the allocator hands the next call the same
    scratch: a status word left from the call before would show as a
    wrong sum."""
    rng = np.random.default_rng(100)
    t, m = 300_007, 150_001
    ins = [(_t(rng.integers(-9, 9, t).astype(np.int32)).to(cuda),
            _t(rng.integers(0, 2, (2, m)).astype(np.int32)).to(cuda))
           for _ in range(2)]
    want = [tts.plain_prefix(b, w) for b, w in ins]
    kernels.reset_launches()
    ok = torch.ones((), dtype=torch.bool, device=cuda)
    for i in range(100):
        gb, gw = tts.prefix_sums(*ins[i % 2])
        ok &= (gb == want[i % 2][0]).all() & (gw == want[i % 2][1]).all()
        del gb, gw
    torch.cuda.synchronize()
    assert bool(ok)
    assert kernels.launches["prefix_sums"] == 100


# -- the docs-axis batched merge and the wire service on the card ---------


def _chain_docs(n_docs, n_ops):
    """``n_docs`` vouched chain documents of ``n_ops`` ops (2 to 64
    replicas each), a with-deletes one among them."""
    from crdt_graph_tpu_torch.bench import workloads
    docs = []
    for i in range(n_docs):
        arrs = workloads.chain_workload(2 << (i % 6), n_ops)
        docs.append(_vouched(arrs, n_ops))
    return docs


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 4, 16])
def test_cuda_batched_equals_singles_and_cpu(cuda, b):
    """``batched_materialize`` on the card: every document's slice equals
    its own single merge on the card and the whole batch equals the CPU
    batch, field for field; the join leg launches the batched forms of
    kernels 1, 3 and 4 once a batch (kernel 1 once more for the delete
    stage a document with deletes brings), and no single kernel."""
    from crdt_graph_tpu_torch import convert
    from crdt_graph_tpu_torch.bench import workloads
    from crdt_graph_tpu_torch.codec import packed
    from crdt_graph_tpu_torch.ops import merge
    from crdt_graph_tpu_torch.parallel import mesh
    docs = _chain_docs(b, 8192)
    if b > 1:
        dels = workloads.chain_with_deletes(4096, 16, 8)
        docs[1] = packed.PackedOps(
            **{k: dels[k] for k in ("kind", "ts", "parent_ts", "anchor_ts",
                                    "depth", "paths", "value_ref", "pos",
                                    "parent_pos", "anchor_pos",
                                    "target_pos")},
            values=list(range(dels["kind"].shape[0])),
            num_ops=int(dels["kind"].shape[0]))
    stacked, aligned = mesh.stack_aligned(docs)
    kernels.reset_launches()
    got = mesh.batched_materialize(stacked)
    torch.cuda.synchronize()
    assert {k: n for k, n in kernels.launches.items() if n} == {
        "plane_rows_batched": 3 if b > 1 else 2, "prefix_sums_batched": 1,
        "monotone_gather_batched": 1}, kernels.launches
    assert got.status.device.type == "cuda"
    want = convert.table_to_numpy(mesh.batched_materialize(stacked,
                                                           device="cpu"))
    have = convert.table_to_numpy(got)
    for f in merge.FIELDS:
        np.testing.assert_array_equal(have[f], want[f], err_msg=f)
    for i, p in enumerate(aligned):
        one = convert.table_to_numpy(merge.materialize(p.arrays(),
                                                       hints="join"))
        two = convert.table_to_numpy(mesh.doc_table(got, i))
        for f in merge.FIELDS:
            np.testing.assert_array_equal(two[f], one[f],
                                          err_msg=f"doc {i} {f}")


def _recording(monkeypatch, names):
    """Wrap the batched kernel wrappers named: each call's arguments
    and output, copied, by name."""
    mods = {"plane_rows_batched": tfr, "plane_rows2_batched": tfr,
            "prefix_sums_batched": tts, "monotone_gather_batched": tmg}
    seen = {}
    for name in names:
        real = getattr(mods[name], name)

        def rec(*args, _real=real, _name=name):
            out = _real(*args)
            outs = out if isinstance(out, tuple) else (out,)
            seen.setdefault(_name, []).append((
                [a.clone() if hasattr(a, "clone") else a for a in args],
                [o.clone() for o in outs]))
            return out
        monkeypatch.setattr(mods[name], name, rec)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("exhaustive", [False, True],
                         ids=["join", "exhaustive"])
def test_cuda_batched_kernels_equal_batched_twins(cuda, monkeypatch,
                                                  exhaustive):
    """At the mesh phase's shapes (16 documents of 65,536 chain ops, 4
    to 512 replicas), every batched kernel call of the batched merge
    equals its batched twin on CPU copies of the same arguments, and
    each kernel of the leg launches once."""
    from crdt_graph_tpu_torch.bench import workloads
    from crdt_graph_tpu_torch.parallel import mesh
    n = 65_536
    docs = [_vouched(workloads.chain_workload(4 << (i % 8), n), n)
            for i in range(16)]
    stacked, _ = mesh.stack_aligned(docs)
    twins = {"plane_rows_batched": tfr.plain_rows_batched,
             "plane_rows2_batched": tfr.plain_rows2_batched,
             "prefix_sums_batched": tts.plain_prefix_batched,
             "monotone_gather_batched": tmg.plain_gather_batched}
    seen = _recording(monkeypatch, twins)
    kernels.reset_launches()
    mesh.batched_materialize(stacked, exhaustive_hints=exhaustive)
    torch.cuda.synchronize()
    launched = {k: n for k, n in kernels.launches.items() if n}
    assert launched == {k: len(v) for k, v in seen.items()}, launched
    assert launched["prefix_sums_batched"] == 1
    assert launched["monotone_gather_batched"] == 1
    assert launched.get("plane_rows2_batched" if exhaustive
                        else "plane_rows_batched")
    for name, calls in seen.items():
        for args, outs in calls:
            want = twins[name](*[a.cpu() if hasattr(a, "cpu") else a
                                 for a in args])
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(outs, want):
                assert g.shape[0] == 16
                np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                              err_msg=name)


@pytest.mark.cuda
def test_cuda_batched_kernels_keep_documents_apart(cuda):
    """Wild indices (negative, past R, the int32 extremes), hops below
    zero and past R, and int32 lanes that wrap: each document reads only
    its own rows and each scan restarts at its document."""
    rng = np.random.default_rng(5)
    b, r, c, t = 3, 20_011, 4, 30_001
    plane = _t(rng.integers(-2**62, 2**62, (b, r, c), dtype=np.int64))
    plane[:, :, 2] = _t(rng.integers(-r // 4, r + 9, (b, r)))
    idx = rng.integers(-2 * r, 2 * r, (b, t)).astype(np.int32)
    idx[:, :6] = [-1, -r, -r - 5, r, 2**31 - 1, -2**31]
    idx = _t(idx)
    got = tfr.plane_rows_batched(plane.to(cuda), idx.to(cuda))
    np.testing.assert_array_equal(
        got.cpu().numpy(), tfr.plain_rows_batched(plane, idx).numpy())
    for g, w in zip(tfr.plane_rows2_batched(plane.to(cuda), idx.to(cuda), 2),
                    tfr.plain_rows2_batched(plane, idx, 2)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    bnd = _t(rng.integers(-2**31, 2**31 - 1, (b, 2 * t),
                          dtype=np.int64).astype(np.int32))
    w = _t(rng.integers(-2**31, 2**31 - 1, (b, 2, t),
                        dtype=np.int64).astype(np.int32))
    for g, want in zip(tts.prefix_sums_batched(bnd.to(cuda), w.to(cuda)),
                       tts.plain_prefix_batched(bnd, w)):
        np.testing.assert_array_equal(g.cpu().numpy(), want.numpy())
    vals = _t(rng.integers(-2**31, 2**31 - 1, (b, 7, 999),
                           dtype=np.int64).astype(np.int32))
    rid = _t(np.sort(rng.integers(-5, 1010, (b, t)), axis=1)
             .astype(np.int32))
    np.testing.assert_array_equal(
        tmg.monotone_gather_batched(vals.to(cuda), rid.to(cuda))
        .cpu().numpy(), tmg.plain_gather_batched(vals, rid).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("exhaustive", [False, True],
                         ids=["join", "exhaustive"])
def test_cuda_batched_merge_equals_per_document_merges(cuda, exhaustive):
    """B = 4 on the card: each document's slice of the one batched merge
    equals its own single merge on the card, field for field."""
    from crdt_graph_tpu_torch import convert
    from crdt_graph_tpu_torch.ops import merge
    from crdt_graph_tpu_torch.parallel import mesh
    stacked, aligned = mesh.stack_aligned(_chain_docs(4, 16_384))
    got = mesh.batched_materialize(stacked, exhaustive_hints=exhaustive)
    for i, p in enumerate(aligned):
        one = convert.table_to_numpy(merge.materialize(
            p.arrays(), hints="exhaustive" if exhaustive else "join"))
        two = convert.table_to_numpy(mesh.doc_table(got, i))
        for f in merge.FIELDS:
            np.testing.assert_array_equal(two[f], one[f],
                                          err_msg=f"doc {i} {f}")


def _chain_body(rid, n, start=1, tag="v"):
    from crdt_graph_tpu_torch.codec import json_codec
    from crdt_graph_tpu_torch.core.operation import Add, Batch
    off = 2**32
    return json_codec.dumps(Batch(tuple(
        Add(rid * off + c, ((rid * off + c - 1) if c > 1 else 0,),
            f"{tag}{rid}.{c}") for c in range(start, start + n))))


@pytest.mark.cuda
def test_cuda_serving_engine_commits_a_grouped_round(cuda):
    """``ServingEngine()`` (the card) groups three same-bucket kernel
    pushes staged into one round into one batched merge; the documents
    equal a CPU engine's that merged them one by one."""
    import threading
    import time
    from crdt_graph_tpu_torch.obs import flight
    from crdt_graph_tpu_torch.serve import ServingEngine
    eng = ServingEngine(start=False, flight=flight.FlightRecorder(),
                        submit_timeout_s=120)
    ref = ServingEngine(device="cpu", cross_doc=False,
                        flight=flight.FlightRecorder(),
                        submit_timeout_s=120)
    try:
        assert eng.device.type == "cuda"
        bodies = {f"g{i}": _chain_body(i + 2, 2048) for i in range(3)}
        boxes = {}
        ths = [threading.Thread(
            target=lambda d=d, b=b: boxes.__setitem__(d, eng.submit(d, b)),
            daemon=True) for d, b in bodies.items()]
        for t in ths:
            t.start()
        deadline = time.monotonic() + 60
        while sum(len(eng.get(d).queue) for d in bodies) < 3:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        kernels.reset_launches()
        assert eng.scheduler.step() == 3
        for t in ths:
            t.join(120)
            assert not t.is_alive()
        assert eng.counters.get("cross_doc_batches") == 1
        # one batched merge on the join leg: each kernel once
        assert {k: n for k, n in kernels.launches.items() if n} == {
            "plane_rows_batched": 2, "prefix_sums_batched": 1,
            "monotone_gather_batched": 1}, kernels.launches
        for d, b in bodies.items():
            assert boxes[d][0]
            assert ref.submit(d, b)[0]
            a, r = eng.get(d).snapshot_view(), ref.get(d).snapshot_view()
            assert list(a.values) == list(r.values)
            assert a.state_fingerprint() == r.state_fingerprint()
            assert bytes(a.ops_since_bytes(0)) == bytes(r.ops_since_bytes(0))
    finally:
        eng.close()
        ref.close()


@pytest.mark.cuda
def test_cuda_document_store_merges_from_two_threads(cuda):
    """The legacy ``DocumentStore`` merges on handler threads: two
    documents' kernel merges launch from two threads at once, and each
    document equals its CPU twin."""
    import threading
    from crdt_graph_tpu_torch.service import DocumentStore
    store, ref = DocumentStore(), DocumentStore(device="cpu")
    assert store.device.type == "cuda"
    bodies = {"p": [_chain_body(2, 3000), _chain_body(2, 2000, start=3001)],
              "q": [_chain_body(3, 2500), _chain_body(4, 2600)]}
    errors = []
    go = threading.Barrier(2)

    def push(doc):
        try:
            go.wait(30)
            for b in bodies[doc]:
                ok, _ = store.get(doc).apply_body(b.encode())
                assert ok
        except BaseException as e:   # noqa: BLE001 — reported below
            errors.append(e)

    kernels.reset_launches()
    ths = [threading.Thread(target=push, args=(d,), daemon=True)
           for d in bodies]
    for t in ths:
        t.start()
    for t in ths:
        t.join(120)
        assert not t.is_alive()
    assert not errors, errors
    torch.cuda.synchronize()
    assert kernels.launches["prefix_sums"] >= 4
    for doc, bs in bodies.items():
        for b in bs:
            assert ref.get(doc).apply_body(b.encode())[0]
        assert store.get(doc).snapshot() == ref.get(doc).snapshot()
        assert store.get(doc).dumps_since_bytes(0) == \
            ref.get(doc).dumps_since_bytes(0)


def _epoch_on(worker, bodies):
    """Every body into ``worker.handle_merge`` from its own thread,
    released together: one epoch of ``len(bodies)`` riders."""
    import threading
    gate = threading.Barrier(len(bodies))
    out = [None] * len(bodies)

    def ride(i):
        gate.wait(60)
        out[i] = worker.handle_merge(bodies[i])

    ths = [threading.Thread(target=ride, args=(i,), daemon=True)
           for i in range(len(bodies))]
    for t in ths:
        t.start()
    for t in ths:
        t.join(300)
        assert not t.is_alive()
    return out


@pytest.mark.cuda
def test_cuda_merge_worker_epoch_equals_cpu(cuda):
    """One worker epoch of four riders on the card equals the same epoch
    on the CPU twins, frame for frame and field for field; the epoch is
    one batched merge, launching the batched forms of kernels 1, 3 and
    4 once each (kernel 1 twice)."""
    from crdt_graph_tpu_torch.mergetier import MergeWorker, wire
    from crdt_graph_tpu_torch.ops.merge import FIELDS
    docs = _chain_docs(4, 65_536)
    bodies = [wire.encode_request(f"d{i}", p, p.num_ops)
              for i, p in enumerate(docs)]
    card = MergeWorker(linger_ms=60_000.0, max_width=4, name="w")
    cpu = MergeWorker(linger_ms=60_000.0, max_width=4, name="w",
                      device="cpu")
    assert card.device.type == "cuda"
    try:
        kernels.reset_launches()
        got = _epoch_on(card, bodies)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        want = _epoch_on(cpu, bodies)
    finally:
        card.close()
        cpu.close()
    assert {k: n for k, n in launches.items() if n} == {
        "plane_rows_batched": 2, "prefix_sums_batched": 1,
        "monotone_gather_batched": 1}, launches
    assert card.stats()["batcher"]["launches"] == 1
    for (gs, gb, _), (ws, wb, _) in zip(got, want):
        assert gs == ws == 200
        gt, gm = wire.decode_response(gb)
        wt, wm = wire.decode_response(wb)
        assert gm == wm and gm["width"] == 4
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(gt, f)),
                                          np.asarray(getattr(wt, f)))


@pytest.mark.cuda
def test_cuda_two_node_fleet_converges(cuda):
    """Two fleet nodes on the card, their grouped and giant merges
    shipped to a merge worker on the card over HTTP, converge by
    anti-entropy to equal fingerprints, equal to a CPU replica fed the
    same ops."""
    import json
    from http.client import HTTPConnection
    from crdt_graph_tpu_torch import cluster, engine, mergetier
    from crdt_graph_tpu_torch.cluster import mergepool
    from crdt_graph_tpu_torch.mergetier.worker import MergeWorkerServer
    from crdt_graph_tpu_torch.serve import ServingEngine
    kv = cluster.MemoryKV()
    ws = MergeWorkerServer(mergetier.MergeWorker(linger_ms=50.0))
    mergepool.register(kv, "w0", ws.addr)
    fleet = {}
    try:
        for n in ("n0", "n1"):
            eng = ServingEngine(
                mergetier=mergetier.MergeTierClient.from_env(src=n, kv=kv))
            assert eng.device.type == "cuda"
            fleet[n] = cluster.FleetServer(n, kv, engine=eng, ttl_s=600.0,
                                           ae_interval_s=3600.0)
        ring = fleet["n0"].node.refresh_ring()
        bodies = {f"d{i}": _chain_body(2 + i, 5000) for i in range(4)}
        for doc, body in bodies.items():
            entry = "n0" if ring.primary(doc) == "n1" else "n1"
            conn = HTTPConnection("127.0.0.1", fleet[entry].port,
                                  timeout=300)
            conn.request("POST", f"/docs/{doc}/ops", body=body)
            r = conn.getresponse()
            ack = json.loads(r.read())
            conn.close()
            assert r.status == 200 and ack["applied_count"] == 5000, ack
            assert ack["served_by"]["name"] != entry
        for fs in fleet.values():
            fs.node.antientropy.sync_now()
        for doc, body in bodies.items():
            replica = engine.init(99, device="cpu")
            replica.apply_wire(body.encode())
            fps = {fs.node.engine.get(doc).read_view().state_fingerprint()
                   for fs in fleet.values()}
            assert len(fps) == 1, (doc, fps)
            for fs in fleet.values():
                assert fs.node.engine.get(doc).snapshot() == \
                    replica.visible_values()
        for fs in fleet.values():
            st = fs.node.engine.mergetier.stats()
            assert st["remote_docs"] >= 1 and not st["fallbacks"], st
        assert ws.worker.stats()["launch_errors"] == 0
    finally:
        for fs in fleet.values():
            fs.stop()
        ws.stop()


@pytest.mark.cuda
def test_cuda_runner_rows_config1_and_config5(cuda):
    """``bench.runner.run`` with no ``device=`` times configs 1 and 5
    (full size) on the card: order-exact in every repeat, the timing
    audit ok, and the merge's kernels launched."""
    from crdt_graph_tpu_torch.bench import runner
    kernels.reset_launches()
    rows = runner.run([1, 5], repeats=2)
    assert [r["config"] for r in rows] == [1, 5]
    for r in rows:
        assert r["device"].startswith("cuda"), r
        assert r["order_check"] == "exact", r
        assert r["audit"]["ok"], r["audit"]
        assert "error" not in r["chain_audit"], r["chain_audit"]
        assert "error" not in r["opsaxis"], r["opsaxis"]
    assert rows[1]["n_ops"] == rows[1]["num_visible"] == 1_000_000
    assert kernels.launches["prefix_sums"] > 0
    assert kernels.launches["monotone_gather"] > 0


@pytest.mark.cuda
def test_cuda_text_buffer_bulk_apply_launches_kernels(cuda):
    """A ``TextBuffer`` on the card (the default): seeding it with one
    5,000-character remote batch merges through the kernels, and an
    editor session on top reads the same as an oracle replica that
    pulls its deltas."""
    from crdt_graph_tpu_torch.bench import incremental
    from crdt_graph_tpu_torch.models import TextBuffer
    buf = TextBuffer(70)
    kernels.reset_launches()
    incremental.seed_document(buf, 5000)
    assert kernels.launches["prefix_sums"] > 0, dict(kernels.launches)
    oracle = TextBuffer(71, engine="oracle")
    oracle.sync_from(buf)
    incremental.editor_replay(buf, 300)
    oracle.sync_from(buf)
    assert buf.text() == oracle.text() and len(buf) > 5000


@pytest.mark.cuda
def test_cuda_shared_wal_commit_crash_recover(cuda, tmp_path, monkeypatch):
    """A durable engine on the card with one shared WAL stream
    (``wal_shared=True``, WAL sync ``batch``): four documents' kernel
    commits, one killed at ``post-fsync-pre-publish``; a fresh engine on
    the card recovers every document with the fingerprint it had, and
    the fsynced killed write."""
    import threading
    from crdt_graph_tpu_torch.obs import flight
    from crdt_graph_tpu_torch.serve import ServingEngine
    monkeypatch.delenv("GRAFT_CRASH_POINT", raising=False)
    ddir = str(tmp_path / "dur")

    def engine():
        return ServingEngine(durable_dir=ddir, wal_sync="batch",
                             wal_shared=True, submit_timeout_s=120,
                             flight=flight.FlightRecorder())

    eng = engine()
    assert eng.device.type == "cuda" and eng.shared_wal is not None
    kernels.reset_launches()
    for i in range(4):
        assert eng.submit(f"w{i}", _chain_body(i + 2, 2048))[0]
    assert eng.flush(60)
    assert kernels.launches["prefix_sums"] >= 4
    fps = {f"w{i}": eng.get(f"w{i}").read_view().state_fingerprint()
           for i in range(4)}
    assert eng.shared_wal.telemetry()["fsyncs"] >= 1
    monkeypatch.setenv("GRAFT_CRASH_POINT", "post-fsync-pre-publish")
    box = {}

    def doomed():
        try:
            box["ack"] = eng.submit("wx", _chain_body(9, 2048))
        except BaseException as e:   # noqa: BLE001 — the kill
            box["err"] = e

    threading.Thread(target=doomed, daemon=True).start()
    eng.scheduler.join(60)
    assert not eng.scheduler.is_alive()
    assert "ack" not in box
    eng.maintenance.stop(timeout=60)
    monkeypatch.delenv("GRAFT_CRASH_POINT")
    eng2 = engine()
    try:
        for d, fp in fps.items():
            doc = eng2.get(d, create=False)
            assert doc is not None and doc.recovered and doc.epoch == 2
            assert doc.read_view().state_fingerprint() == fp
        assert len(eng2.get("wx", create=False).read_view().values) == 2048
    finally:
        eng2.close()


@pytest.mark.cuda
def test_cuda_shmcache_attach_between_engines(cuda, monkeypatch):
    """Two engines on the card with the host-shared body cache in one
    namespace, fed the same kernel commit: the first read encodes (a
    miss), the second attaches its segment (a hit) with identical bytes;
    no segment is left after both close."""
    import os
    import uuid
    from crdt_graph_tpu_torch.serve import ServingEngine
    ns = f"t{uuid.uuid4().hex[:10]}"
    monkeypatch.setenv("GRAFT_SHMCACHE_NS", ns)
    engs = [ServingEngine(shmcache=True, submit_timeout_s=120)
            for _ in range(2)]
    try:
        body = _chain_body(3, 4096)
        snaps = []
        for e in engs:
            assert e.device.type == "cuda" and e.shmcache is not None
            assert e.submit("d", body)[0]
            snaps.append(e.get("d").read_view())
        got = [(bytes(s.values_body()), bytes(s.clock_body()),
                s.shm_seg_name) for s in snaps]
        assert got[0] == got[1] and got[0][2] is not None
        st = [e.shmcache.stats.snapshot() for e in engs]
        assert (st[0]["misses"], st[0]["hits"]) == (1, 0)
        assert (st[1]["misses"], st[1]["hits"]) == (0, 1)
    finally:
        for e in engs:
            e.close()
    left = [f for f in os.listdir("/dev/shm")
            if ns in f and not f.endswith(".manifest")]
    assert left == []


@pytest.mark.cuda
@pytest.mark.parametrize("deletes", [False, True])
def test_cuda_chain_audit_card_equals_cpu(cuda, deletes):
    """The trace audit counts the same rows on the card as on the CPU at
    the sampler's floor (65,536 ops), config 5 and its deletes batch: a
    kernel call is one row on both, the card's syncs are the CPU's, and
    both are within their budgets."""
    from crdt_graph_tpu_torch.bench import workloads
    from crdt_graph_tpu_torch.utils import chainaudit
    n = 65_536
    arrs = workloads.chain_with_deletes(n, 16, 64) if deletes else \
        workloads.chain_workload(64, n)
    on = chainaudit.audit_materialize(arrs, "exhaustive", not deletes, cuda)
    off = chainaudit.audit_materialize(arrs, "exhaustive", not deletes,
                                       "cpu")
    assert on.rows == off.rows
    assert on.summary() == off.summary()
    assert on.summary()["ok"], on.summary()
    assert on.kernel_calls["prefix_sums"] == 1


@pytest.mark.cuda
def test_cuda_chain_audit_kernel_calls_equal_profiler_events(cuda):
    """Each kernel call the audit counts is one CUDA kernel of that name
    in a ``torch.profiler`` trace of the same merge."""
    from torch.profiler import ProfilerActivity, profile

    from crdt_graph_tpu_torch import convert
    from crdt_graph_tpu_torch.bench import workloads
    from crdt_graph_tpu_torch.ops import merge
    from crdt_graph_tpu_torch.utils import chainaudit
    events = {"plane_rows": "plane_rows_kernel",
              "plane_rows2": "plane_rows2_kernel",
              "prefix_sums": "scan_lookback",
              "monotone_gather": "mono_gather_kernel"}
    arrs = workloads.chain_with_deletes(262_144, 16, 64)
    audit = chainaudit.audit_materialize(arrs, "exhaustive", False, cuda)
    cols = convert.ops_from_numpy(arrs, cuda)
    merge._materialize(cols, "exhaustive", cuda, False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        merge._materialize(cols, "exhaustive", cuda, False)
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if getattr(ev, "device_type", None) ==
             torch.autograd.DeviceType.CUDA]
    got = {k: sum(1 for nm in names if ev in nm) for k, ev in events.items()}
    assert {k: v for k, v in got.items() if v} == audit.kernel_calls


def _record_calls(monkeypatch):
    """Every kernel wrapper records ``(name, args, out)`` for each call
    (copies, so later calls cannot change them)."""
    calls = []
    for mod, name in ((tfr, "plane_rows"), (tfr, "plane_rows2"),
                      (tts, "prefix_sums"), (tmg, "monotone_gather"),
                      (tts, "ring_exclusive")):
        orig = getattr(mod, name)

        def rec(*args, _orig=orig, _name=name):
            out = _orig(*args)
            copy = lambda x: type(x)(copy(y) for y in x) \
                if isinstance(x, (list, tuple)) else \
                (x.clone() if hasattr(x, "clone") else x)
            calls.append((_name, copy(args), copy(out)))
            return out
        monkeypatch.setattr(mod, name, rec)
    return calls


def _twin_mismatches(calls):
    twins = {"plane_rows": tfr.plain_rows, "plane_rows2": tfr.plain_rows2,
             "prefix_sums": tts.plain_prefix,
             "monotone_gather": tmg.plain_gather,
             "ring_exclusive": tts.plain_ring_exclusive}
    cpu = lambda x: type(x)(cpu(y) for y in x) \
        if isinstance(x, (list, tuple)) else \
        (x.cpu() if hasattr(x, "cpu") else x)
    bad = []
    for name, args, out in calls:
        want = twins[name](*cpu(args))
        got = out if isinstance(out, (list, tuple)) else (out,)
        want = want if isinstance(want, (list, tuple)) else (want,)
        if len(got) != len(want) or not all(
                torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            bad.append(name)
    return bad


@pytest.mark.cuda
def test_cuda_headline_entry_points_kernels_equal_twins(cuda, tmp_path,
                                                        monkeypatch):
    """The serving headline (a 16,384-op giant racer beside 12-leaf
    sessions) and the ops-axis headline (k = 8 logical shards, kernel 5)
    at a small depth on the card, with no ``device=``: zero violations,
    the sharded merge bit-identical to the single one, and every kernel
    call of both equal to its twin."""
    from crdt_graph_tpu_torch.scripts import (bench_opsaxis_headline,
                                              bench_serve_headline)
    calls = _record_calls(monkeypatch)
    kernels.reset_launches()
    serve = bench_serve_headline.run(
        n_sessions=8, writes_per_session=2, n_docs=2, giant_ops=16_384,
        out_path=str(tmp_path / "serve.json"))
    ops = bench_opsaxis_headline.run(
        65_536, 1, str(tmp_path / "opsaxis.json"))
    assert serve["violations_total"] == 0
    assert not serve["report"]["errors"]
    assert serve["device"]["power_limit"] is not None
    assert ops["bit_identical"] and ops["devices"] >= 2
    names = {c[0] for c in calls}
    assert {"plane_rows2", "prefix_sums", "monotone_gather",
            "ring_exclusive"} <= names, names
    assert not _twin_mismatches(calls)
    assert sum(kernels.launches.values()) >= len(calls)


@pytest.mark.cuda
@pytest.mark.parametrize("hints", ["auto", "exhaustive"])
def test_cuda_partitioned_resolve_and_ops_axis_mesh(cuda, hints):
    """``shard_materialize`` and ``sharded_materialize`` on 8 logical
    devices of the card equal the single-device merge on the card and
    the partitioned resolve on the CPU, field for field; the tail
    launches kernels 1, 3 and 4, the ops-axis merge kernel 5."""
    from crdt_graph_tpu_torch import convert
    from crdt_graph_tpu_torch.bench import workloads
    from crdt_graph_tpu_torch.codec import packed
    from crdt_graph_tpu_torch.ops import merge
    from crdt_graph_tpu_torch.parallel import mesh, shard
    arrs = workloads.chain_with_deletes(57_344, 16, 64)
    m = mesh.make_mesh(1, 8, devices=[cuda] * 8)
    cols = packed.pad_arrays(arrs, mesh.round_up(arrs["kind"].shape[0], 8))
    want = convert.table_to_numpy(merge.materialize(cols, device=cuda))
    kernels.reset_launches()
    got = convert.table_to_numpy(shard.shard_materialize(cols, m, hints))
    torch.cuda.synchronize()
    for k in ("plane_rows", "prefix_sums", "monotone_gather"):
        assert kernels.launches[k] >= 1, k
    cpu = convert.table_to_numpy(shard.shard_materialize(
        cols, mesh.make_mesh(1, 8, devices=["cpu"] * 8), hints))
    kernels.reset_launches()
    ops_axis = convert.table_to_numpy(mesh.sharded_materialize(cols, m))
    torch.cuda.synchronize()
    assert kernels.launches["ring_exclusive"] >= 1
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        np.testing.assert_array_equal(cpu[f], want[f], err_msg=f)
        np.testing.assert_array_equal(ops_axis[f], want[f], err_msg=f)
