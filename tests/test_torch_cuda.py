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
                                "prefix_sums": 2, "monotone_gather": 2}


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
