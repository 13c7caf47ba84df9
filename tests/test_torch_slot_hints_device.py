"""The slot hints derived on the device (``ops.slot_hints.derive``)
against their host statement (``codec.packed.derive_slot_hints``), and
the replica engine's bulk merge that derives them after the copy against
the merge of ``arrays()``'s host-derived columns.

Every column must be equal, dtype included; where the NumPy crowding
pre-pass returns None, the device's verification must read false.  The
packings: config 5's flat chains at 65,536 ops, the nested generator at
depth 8, a batch with deletes, a ``concat_many`` union with duplicate
timestamps across its parts and pad rows up to its power-of-two
capacity, an unresolved parent, non-causal anchors, a depth mismatch and
a prefix mismatch.  The ``cuda`` case runs the same comparison on the
card and skips elsewhere.  This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_slot_hints_device.py -q
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crdt_graph_tpu_torch import convert
from crdt_graph_tpu_torch import engine as tengine
from crdt_graph_tpu_torch.bench import workloads as tw
from crdt_graph_tpu_torch.codec import packed as tpacked
from crdt_graph_tpu_torch.core.operation import Add
from crdt_graph_tpu_torch.ops import merge as tmerge
from crdt_graph_tpu_torch.ops import slot_hints
from crdt_graph_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)


def _ts(rid, counter):
    return rid * 2**32 + counter


def _chain(rid, start, count, parent=()):
    """Adds ``start+1 .. start+count`` of replica ``rid``'s chain under
    the branch ``parent``."""
    return [Add(_ts(rid, c), parent + (_ts(rid, c - 1) if c > 1 else 0,),
                c) for c in range(start + 1, start + count + 1)]


def _vouched(arrs):
    """A vouched ``PackedOps`` over a workload's columns."""
    n = int(np.sum(arrs["kind"] != tpacked.KIND_PAD))
    return tpacked.PackedOps(
        kind=arrs["kind"], ts=arrs["ts"], parent_ts=arrs["parent_ts"],
        anchor_ts=arrs["anchor_ts"], depth=arrs["depth"],
        paths=arrs["paths"], value_ref=arrs["value_ref"], pos=arrs["pos"],
        values=list(range(n)), num_ops=n, parent_pos=arrs["parent_pos"],
        anchor_pos=arrs["anchor_pos"], target_pos=arrs["target_pos"],
        ts_rank=arrs["ts_rank"], hints_vouched=True)


def _dup_union():
    """Two parts that both carry replica 1's adds 601-700, unioned into
    1,600 rows padded to 2,048."""
    a = tpacked.pack(_chain(1, 0, 700) + _chain(2, 0, 300))
    b = tpacked.pack(_chain(1, 600, 400) + _chain(3, 0, 200))
    u = tpacked.concat_many([a, b])
    assert u.hints_vouched and u.capacity == 2048 and u.num_ops == 1600
    assert np.unique(u.ts[:u.num_ops]).size == 1500
    return u


def _nested_faults(fault):
    """Branches b1 (root) and b2 (in b1), a chain in b2, and one add
    whose depth or prefix does not match its parent's path."""
    b1, b2 = _ts(1, 1), _ts(1, 2)
    ops = [Add(b1, (0,), "b1"), Add(b2, (b1, 0), "b2")]
    ops += _chain(2, 0, 300, parent=(b1, b2))
    if fault == "depth":        # b2's child claimed at depth 2, not 3
        ops.append(Add(_ts(3, 1), (b2, 0), "x"))
    else:                       # b2's child under a prefix b1 is not
        ops.append(Add(_ts(3, 1), (_ts(5, 5), b2, 0), "x"))
    return tpacked.pack(ops)


# name -> a vouched PackedOps; the engine merges the valid ones
CASES = {
    "chain65536": lambda: _vouched(tw.chain_workload(64, 65536)),
    "nested8": lambda: tpacked.pack(tw.nested_tree(6000, 8, depth=8)),
    "deletes": lambda: _vouched(tw.chain_with_deletes(4096, 16, 64)),
    "dup_union": _dup_union,
    "unresolved_parent": lambda: tpacked.pack(
        _chain(1, 0, 500) + [Add(_ts(9, 1), (_ts(8, 5), 0), "x")]),
    "non_causal": lambda: _vouched(tw.descending_chains(64, 4096)),
    "depth_mismatch": lambda: _nested_faults("depth"),
    "prefix_mismatch": lambda: _nested_faults("prefix"),
}
# where the NumPy crowding pre-pass verifies
CROWD_VERIFIES = {"chain65536", "nested8", "dup_union"}
MERGED = ("chain65536", "nested8", "deletes", "dup_union", "non_causal")


def _counted(recs, name):
    return sum(r["counts"].get(name, 0) for r in recs)


def _compare(p, device):
    src = {k: v for k, v in p.columns().items()
           if k in slot_hints.SOURCE_COLS}
    want = tpacked.derive_slot_hints(src)
    t = convert.ops_from_numpy(src, device)
    for crowding in (True, False):
        got, ok = slot_hints.derive(t, crowding)
        if crowding:
            assert bool(ok) == ("crowd_slot" in want)
        else:
            assert ok is None
        keys = [k for k in want if crowding or k in tpacked.SLOT_HINT_COLS]
        if not ok:
            keys = [k for k in keys if k not in tpacked.CROWD_HINT_COLS]
        assert set(tpacked.SLOT_HINT_COLS) <= set(keys)
        for k in keys:
            g = got[k].cpu().numpy()
            assert g.dtype == want[k].dtype, k
            np.testing.assert_array_equal(g, want[k], err_msg=k)
    return want


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_columns_equal_the_host_derivation(case):
    p = CASES[case]()
    want = _compare(p, "cpu")
    assert ("crowd_slot" in want) == (case in CROWD_VERIFIES)
    assert np.any(p.kind == tpacked.KIND_DELETE) == (case == "deletes")


@pytest.mark.parametrize("s_cap", [None, "1024"])
@pytest.mark.parametrize("case", MERGED)
def test_engine_merge_equals_the_merge_of_host_hints(case, s_cap,
                                                     monkeypatch):
    """The engine's bulk merge (columns without slot hints, derived on
    the device) parks the table ``materialize(arrays(), "exhaustive")``
    gives, on the same leg and crowding choice, and counts one
    derivation and, where its crowd columns were derived and refused,
    one refusal.  A sort width of 1,024 puts every case on the
    compacted sibling branch, where the crowd columns are read."""
    if s_cap is not None:
        monkeypatch.setenv("GRAFT_S_CAP", s_cap)
    p = CASES[case]()
    seen = []
    finish = tmerge._finish

    def spy(ops, sel, no_deletes, *a, **k):
        # the fused slot leg; the crowd columns replace a sibling count
        seen.append((sel[2] is None, tmerge._crowd_cols(ops, no_deletes)
                     and tmerge._compacted(ops["kind"].shape[-1])))
        return finish(ops, sel, no_deletes, *a, **k)

    monkeypatch.setattr(tmerge, "_finish", spy)
    tree = tengine.TpuTree(99, device="cpu")
    merged = []     # (candidate set, its table) of the engine's merge
    finish_packed = tree.finish_packed

    def keep(pnew, cand, table):
        merged.append((cand, convert.table_to_numpy(table)))
        return finish_packed(pnew, cand, table)

    monkeypatch.setattr(tree, "finish_packed", keep)
    assert tree.packed_route(p.num_ops)
    tprof.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        tree.apply_packed(p)
    recs = tprof.span_log()["records"]
    ((cand, got),) = merged
    arrs = cand.arrays()
    assert tmerge.select_leg(arrs, "exhaustive") == "slot"
    want = convert.table_to_numpy(
        tmerge.materialize(arrs, "exhaustive", device="cpu"))
    for f in tmerge.FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert len(seen) == 2 and seen[0] == seen[1] and seen[0][0]
    no_del = tmerge.host_no_deletes(arrs["kind"])
    assert seen[0][1] == tmerge.crowding_hinted(arrs, "exhaustive", no_del)
    counted = {name: _counted(recs, name) for name in
               ("merge.slot_hints_on_card", "merge.crowd_hints_refused")}
    derived = no_del and tmerge._compacted(cand.capacity)
    refused = derived and "crowd_slot" not in arrs
    assert counted == {"merge.slot_hints_on_card": 1,
                       "merge.crowd_hints_refused": int(refused)}
    tprof.reset_spans()


def test_derive_hints_takes_only_vouched_single_documents():
    p = CASES["dup_union"]()
    cols = p.columns()
    for bad in (dict(hints=None), dict(hints="auto")):
        with pytest.raises(ValueError):
            tmerge.materialize(cols, device="cpu", derive_hints=True, **bad)
    no_rank = {k: v for k, v in cols.items() if k != "ts_rank"}
    with pytest.raises(ValueError):
        tmerge.materialize(no_rank, "exhaustive", device="cpu",
                           derive_hints=True)


def test_unvouched_packing_keeps_the_verified_mode(monkeypatch):
    """An unvouched packing (a restored log with defaulted hints) merges
    ``arrays()`` in the verified auto mode: no derivation on the
    device."""
    p = CASES["dup_union"]()
    p.hints_vouched = False
    calls = []
    derive = slot_hints.derive
    monkeypatch.setattr(slot_hints, "derive",
                        lambda *a: calls.append(1) or derive(*a))
    tree = tengine.TpuTree(99, device="cpu")
    tree.apply_packed(p)
    assert calls == []
    assert len(tree.visible_values()) == 1500


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_card_columns_equal_the_host_derivation(case, cuda):
    want = _compare(CASES[case](), cuda)
    assert ("crowd_slot" in want) == (case in CROWD_VERIFIES)


@pytest.mark.cuda
def test_card_columns_at_the_catchup_capacity(cuda):
    """Config 5's 1M ops padded to 2,097,152 rows, as the catch-up
    cell's candidate sets are."""
    arrs = tw.chain_workload(64, 1_000_000)
    arrs = tpacked.pad_arrays(
        {k: arrs[k] for k in tpacked.PackedOps.__dataclass_fields__
         if k in arrs}, 1 << 21)
    want = _compare(_vouched(arrs), cuda)
    assert "crowd_slot" in want


def test_audit_holds_the_derivation_apart_and_to_its_budget(monkeypatch):
    """Under the trace audit the derivation's passes are counted apart
    (``hint_passes``) and held to their own budget; the merge's fast
    path is the merge of the host-derived columns' own."""
    from crdt_graph_tpu_torch.utils import chainaudit
    monkeypatch.setenv("GRAFT_S_CAP", "1024")
    p = CASES["dup_union"]()
    tree = tengine.TpuTree(99, device="cpu")
    with chainaudit.Audit() as a:
        tree.apply_packed(p)
    res = a.result()
    ref = chainaudit.audit_materialize(p.arrays(), "exhaustive", True,
                                       "cpu").summary()
    got = res.summary()
    assert got["fast_path"] == ref["fast_path"] and got["ok"]
    assert got["hint_passes"] == 17 and ref["hint_passes"] == 0
    assert got["hint_budget"] == chainaudit.HINT_PASS_BUDGET
    monkeypatch.setattr(chainaudit, "HINT_PASS_BUDGET", 16)
    assert not res.summary()["ok"]
