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
