"""The hand kernels' work (``crdtbench.kernelwork``), through the
wrappers' plain twins on the CPU: a batched call's work is its
documents' unbatched work together, and one captured catch-up step
calls the unbatched wrappers only."""
import pytest
import torch

from crdtbench import kernelwork
from crdtbench.kernelwork import Capture, work_of
from crdt_graph_tpu_torch.ops import fused_resolve, mono_gather, tour_scan


def _args(name, b, g):
    """Arguments of the batched wrapper ``name`` with ``b`` documents:
    indices that wrap, clamp and repeat; hops that are -1 or in range."""
    r, c, t = 40, 3, 64
    if name in ("plane_rows_batched", "plane_rows2_batched"):
        plane = torch.randint(-1, r + 8, (b, r, c), generator=g)
        idx = torch.randint(-r - 5, r + 5, (b, t), generator=g,
                            dtype=torch.int32)
        return (plane, idx) if name == "plane_rows_batched" \
            else (plane, idx, 1)
    if name == "prefix_sums_batched":
        return (torch.randint(0, 2, (b, t), generator=g, dtype=torch.int32),
                torch.randint(0, 9, (b, 2, t + 4), generator=g,
                              dtype=torch.int32))
    vals = torch.randint(0, 99, (b, 4, r), generator=g, dtype=torch.int32)
    rid = torch.sort(torch.randint(-2, r + 2, (b, t), generator=g,
                                   dtype=torch.int32)).values
    return vals, rid


WRAPPER = {"plane_rows_batched": (fused_resolve, "plane_rows"),
           "plane_rows2_batched": (fused_resolve, "plane_rows2"),
           "prefix_sums_batched": (tour_scan, "prefix_sums"),
           "monotone_gather_batched": (mono_gather, "monotone_gather")}


def _one(a):
    return a[0] if isinstance(a, torch.Tensor) else a


def test_capture_wraps_both_forms():
    assert {f for _, f in kernelwork.WRAPPERS} == {
        *WRAPPER, *(f for _, f in WRAPPER.values())}


@pytest.mark.parametrize("name", sorted(WRAPPER))
def test_a_batch_of_one_is_bound_as_its_document(name):
    mod, one = WRAPPER[name]
    args = _args(name, 1, torch.Generator().manual_seed(7))
    with Capture() as batched:
        getattr(mod, name)(*args)
    with Capture() as single:
        getattr(mod, one)(*[_one(a) for a in args])
    assert batched.bound_ms == single.bound_ms > 0
    assert batched.calls == {name: 1} and single.calls == {one: 1}


@pytest.mark.parametrize("name", sorted(WRAPPER))
def test_a_batch_is_the_sum_of_its_documents(name):
    _, one = WRAPPER[name]
    args = _args(name, 3, torch.Generator().manual_seed(11))
    docs = [work_of(one, [a[b] if isinstance(a, torch.Tensor) else a
                          for a in args]) for b in range(3)]
    assert work_of(name, args) == (sum(d[0] for d in docs),
                                   sum(d[1] for d in docs))
    if name != "prefix_sums_batched":    # its work is its shapes'
        assert len(set(docs)) > 1        # the documents' work differs


def test_a_catchup_step_calls_the_unbatched_wrappers_only():
    from crdtbench.drivers import catchup
    from crdtbench.tests.conftest import TINY
    cfg = {"local_replica": 65}
    tr = {}
    TINY["rga64x1M.catchup"](cfg, tr)
    drv = catchup.Driver(cfg, tr, 9, "cpu", False)
    drv.setup()
    with Capture() as c:
        drv.step(drv.delta_p[-1])
    assert c.bound_ms > 0 and c.calls
    assert not [f for f in c.calls if f.endswith(kernelwork.BATCHED)]
