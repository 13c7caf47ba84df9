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
