"""The PyTorch port's merge against the JAX reference, on the CPU.

The same packed columns (made by each package's own codec from the same
operations, or by the shared numpy generators) go through
``crdt_graph_tpu.ops.merge.materialize(..., hints="exhaustive")`` and
``crdt_graph_tpu_torch.ops.merge.materialize(..., hints="exhaustive",
device="cpu")`` (the other hint modes: ``test_torch_hints.py``); every
``NodeTable`` field must be equal, dtype included (integer data: exact).
"""
import random

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

# the suite runs several workers at once: keep PyTorch's CPU ops on one
# thread each so they do not oversubscribe the box
torch.set_num_threads(1)

import crdt_graph_tpu as crdt  # noqa: E402
from crdt_graph_tpu import Add  # noqa: E402
from crdt_graph_tpu.bench import workloads as jw  # noqa: E402
from crdt_graph_tpu.codec import json_codec as jjson  # noqa: E402
from crdt_graph_tpu.codec import packed as jpacked  # noqa: E402
from crdt_graph_tpu.core import operation as jop  # noqa: E402
from crdt_graph_tpu.ops import merge as jmerge  # noqa: E402
from crdt_graph_tpu.ops import view as jview  # noqa: E402

from crdt_graph_tpu_torch import convert  # noqa: E402
from crdt_graph_tpu_torch.bench import workloads as tw  # noqa: E402
from crdt_graph_tpu_torch.codec import json_codec as tjson  # noqa: E402
from crdt_graph_tpu_torch.codec import packed as tpacked  # noqa: E402
from crdt_graph_tpu_torch.ops import merge as tmerge  # noqa: E402
from crdt_graph_tpu_torch.ops import view as tview  # noqa: E402

CAP_VARS = ("GRAFT_S_CAP", "GRAFT_S_CAP2", "GRAFT_R_CAP", "GRAFT_R_CAP2")


def _port_ops(ops):
    """The reference's op objects → the port's, through the wire JSON."""
    return tjson.loads(jjson.dumps(jop.from_list(ops)))


def _both_packed(ops, **kw):
    """Pack the same ops with each package's codec; the columns agree."""
    jp = jpacked.pack(ops, **kw)
    tp = tpacked.pack(_port_ops(ops), **kw)
    ja, ta = jp.arrays(), tp.arrays()
    assert sorted(ja) == sorted(ta)
    for k in ja:
        np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)
        assert ja[k].dtype == ta[k].dtype, k
    return ja, ta, jp, tp


def _assert_tables_equal(jt, tt, tag=""):
    got = convert.table_to_numpy(tt)
    for f in tmerge.FIELDS:
        want = np.asarray(getattr(jt, f))
        assert got[f].dtype == want.dtype, f"{tag} field {f} dtype"
        np.testing.assert_array_equal(got[f], want,
                                      err_msg=f"{tag} field {f}")


def _check(arrs, tarrs=None, tag="", **jax_kw):
    jt = jview.to_host(jmerge.materialize(arrs, hints="exhaustive",
                                          **jax_kw))
    tt = tmerge.materialize(arrs if tarrs is None else tarrs,
                            hints="exhaustive", device="cpu")
    _assert_tables_equal(jt, tt, tag)
    return jt, tt


def _small_configs(pkg):
    """Configs 1-8 at reduced size, from one package's generators and
    codec (1 and 4 carry deletes)."""
    w, p = (jw, jpacked) if pkg == "jax" else (tw, tpacked)
    return {
        1: lambda: p.pack(w.editor_replay(400)).arrays(),
        2: lambda: p.pack(w.two_replica_interleaved(800)).arrays(),
        3: lambda: p.pack(w.nested_tree(1500, 4)).arrays(),
        4: lambda: p.pack(w.tombstone_heavy(600, 8)).arrays(),
        5: lambda: w.chain_workload(4, 2048),
        6: lambda: w.descending_chains(64, 2048),
        7: lambda: w.comb_pairs(2048),
        8: lambda: w.deep_paths(8, 2048),
    }


@pytest.mark.parametrize("cid", range(1, 9))
def test_configs_match_lax_trace(cid):
    """Each config from the port's own generators and codec equals the
    reference's columns, and the merges agree on every field."""
    ja = _small_configs("jax")[cid]()
    ta = _small_configs("torch")[cid]()
    assert sorted(ja) == sorted(ta)
    for k in ja:
        np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)
    _check(ja, ta, tag=f"config {cid}")


@pytest.mark.parametrize("cid", [4, 5])
def test_configs_match_device_trace(cid, monkeypatch):
    """Against the reference's device trace (its Pallas kernels through
    the interpreter, the fused two-hop node frame)."""
    monkeypatch.setenv("GRAFT_PALLAS_INTERPRET", "1")
    arrs = _small_configs("jax")[cid]()
    _check(arrs, tag=f"pallas config {cid}", use_pallas=True)


@pytest.mark.parametrize("caps", [(64, 16, 64, 16), (512, 8, 256, 8),
                                  (1024, 512, 16, 16)])
@pytest.mark.parametrize("cid", [2, 4, 7])
def test_compact_tiers_match(caps, cid, monkeypatch, request):
    """Small S_CAP/R_CAP/*_CAP2 in both packages: the compact sibling and
    run tiers and their fallbacks run, and still agree."""
    for name, v in zip(CAP_VARS, caps):
        monkeypatch.setenv(name, str(v))
    jax.clear_caches()
    request.addfinalizer(jax.clear_caches)
    arrs = _small_configs("jax")[cid]()
    _check(arrs, tag=f"caps {caps} config {cid}")


@pytest.mark.parametrize("cid", [4, 5])
def test_probe_checksums_match(cid):
    """``probe=k`` cuts return the reference's cumulative checksums, so a
    parity failure names the first stage that diverges."""
    arrs = _small_configs("jax")[cid]()
    nd = jmerge.host_no_deletes(arrs["kind"])
    for k in (1, 2, 3, 4, 41, 42, 43, 5, 6, 7):
        want = int(jmerge._materialize(arrs, None, "exhaustive", nd, k))
        got = tmerge.materialize(arrs, hints="exhaustive", device="cpu",
                                 probe=k)
        assert got == want, f"config {cid} probe {k}"


def _random_session(seed, n_replicas=4, steps=120):
    """Replicas editing and syncing through the reference's oracle; the
    merged op log."""
    rng = random.Random(seed)
    trees = [crdt.init(r + 1) for r in range(n_replicas)]
    for _ in range(steps):
        i = rng.randrange(n_replicas)
        t = trees[i]
        roll = rng.random()
        try:
            if roll < 0.5:
                t = t.add(rng.randrange(1000))
            elif roll < 0.65:
                t = t.add_branch(rng.randrange(1000))
            elif roll < 0.8:
                vis = []
                t.walk(lambda n, acc: (crdt.TAKE, acc.append(n.path) or acc),
                       vis)
                if vis:
                    t = t.delete(rng.choice(vis))
            else:
                j = rng.randrange(n_replicas)
                if j != i:
                    t = t.apply(trees[j].operations_since(0))
        except crdt.CRDTError:
            pass
        trees[i] = t
    for i in range(n_replicas):
        for j in range(n_replicas):
            if i != j:
                trees[i] = trees[i].apply(trees[j].operations_since(0))
    return trees[0], jop.to_list(trees[0].operations_since(0))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_delivery_orders_match(seed):
    """Random multi-replica logs, in causal order and in shuffled
    delivery orders re-packed from the same ops: the tables agree, and
    the port's visible values equal the oracle's."""
    merged, ops = _random_session(seed)
    want = merged.visible_values()
    rng = random.Random(seed + 100)
    for trial in range(3):
        order = ops[:] if trial == 0 else rng.sample(ops, len(ops))
        ja, ta, jp, tp = _both_packed(order)
        _, tt = _check(ja, ta, tag=f"seed {seed} order {trial}")
        assert tview.visible_values(tview.to_host(tt), tp.values) == want


@pytest.mark.parametrize("ops", [
    # anchor cycles (1-, 2- and 3-cycles) among valid ops
    [Add(1, (0,), "x"), Add(5, (5,), "a"), Add(2, (1,), "y")],
    [Add(1, (0,), "x"), Add(5, (7,), "a"), Add(7, (5,), "b"),
     Add(2, (1,), "y")],
    [Add(1, (0,), "x"), Add(5, (9,), "a"), Add(7, (5,), "b"),
     Add(9, (7,), "c"), Add(2, (1,), "y")],
    # missing anchor / missing intermediate / invalid parent cascade
    [Add(1, (0,), "a"), Add(2, (9,), "b")],
    [Add(1, (0,), "a"), Add(2, (7, 0), "b"), Add(3, (2, 0), "c")],
    # duplicates and empty paths
    [Add(1, (0,), "a")] * 3 + [Add(10, (), "y")],
], ids=["cycle1", "cycle2", "cycle3", "missing_anchor",
        "invalid_parent", "dups_empty"])
def test_adversarial_batches_match(ops):
    """Cycles, unresolved references and duplicates: the rejection and
    status branches agree."""
    ja, ta, _, _ = _both_packed(ops)
    _check(ja, ta)


def test_ascending_chain_takes_binary_lifting():
    """A late small-timestamp op anchored at the tail of a long ascending
    chain outruns the NSA chase's trip cap: the binary-lifting finish
    runs, and agrees."""
    big = 2 * 2**32
    ops = [Add(big + 1, (0,), "A"), Add(big + 2, (big + 1,), "X")]
    prev = big + 1
    for k in range(3, 43):
        ops.append(Add(big + k, (prev,), f"c{k}"))
        prev = big + k
    ops.append(Add(2**32 + 1, (prev,), "Z"))
    ja, ta, _, tp = _both_packed(ops)
    _, tt = _check(ja, ta)
    assert tview.visible_values(tview.to_host(tt), tp.values)[-2:] == \
        ["X", "Z"]


@pytest.mark.parametrize("drop", [("parent_row",), ("win_row",),
                                  ("parent_row", "win_row")])
@pytest.mark.parametrize("cid", [3, 4])
def test_without_host_frames_match(drop, cid):
    """Without ``parent_row`` the node frame takes one hop and the parent
    frame its own row gather (kernel 1); without ``win_row`` the winner
    frame is the scatter-min.  Same table."""
    arrs = {k: v for k, v in _small_configs("jax")[cid]().items()
            if k not in drop}
    _check(arrs, tag=f"config {cid} without {drop}")


def test_view_readers_match():
    merged, ops = _random_session(7, n_replicas=3, steps=80)
    ja, ta, jp, tp = _both_packed(ops)
    jt, tt = _check(ja, ta)
    ht = tview.to_host(tt)
    assert tview.visible_values(ht, tp.values) == \
        jview.visible_values(jt, jp.values)
    assert tview.visible_paths(ht) == jview.visible_paths(jt)
    assert tview.statuses(ht, tp.num_ops) == jview.statuses(jt, jp.num_ops)
    np.testing.assert_array_equal(tview.visible_slots(ht),
                                  jview.visible_slots(jt))
    for path in jview.visible_paths(jt)[:5] + [(12345,)]:
        assert tview.get_value(ht, tp.values, path) == \
            jview.get_value(jt, jp.values, path)


def test_table_round_trips_through_numpy():
    arrs = _small_configs("jax")[4]()
    jt = jview.to_host(jmerge.materialize(arrs, hints="exhaustive"))
    tt = convert.table_from_numpy(jt, "cpu")
    _assert_tables_equal(jt, tt)
    back = convert.table_from_numpy(convert.table_to_numpy(tt), "cpu")
    _assert_tables_equal(jt, back)


def test_config5_closed_form_order():
    """The north-star workload's shape at reduced size: the visible
    timestamps equal the closed form, element for element."""
    n = 8192
    t = tview.to_host(tmerge.materialize(tw.chain_workload(64, n),
                                         hints="exhaustive", device="cpu"))
    assert int(t.num_visible) == n
    seq = t.ts[t.visible_order[:n]]
    np.testing.assert_array_equal(seq, tw.chain_expected_ts(64, n))


def test_unknown_hints_mode_raises():
    """An unknown hint mode is refused with the reference's error, before
    any work (and with or without slot hints)."""
    arrs = tw.chain_workload(4, 64)
    bare = {k: v for k, v in arrs.items()
            if k not in tpacked.SLOT_HINT_COLS}
    for a in (arrs, bare):
        for h in ("exhaustiv", "", "AUTO", "sorted", 0):
            with pytest.raises(ValueError, match="unknown hints mode"):
                tmerge.materialize(a, hints=h, device="cpu")
            with pytest.raises(ValueError, match="unknown hints mode"):
                jmerge.materialize(a, hints=h)


def test_tensor_inputs_and_host_syncs_counted():
    """Tensor columns merge like numpy ones; every predicate read back
    from the device is counted."""
    arrs = tw.chain_workload(4, 2048)
    tens = convert.ops_from_numpy(arrs, "cpu")
    assert isinstance(tens["ts"], torch.Tensor)
    tmerge.host_syncs = 0
    a = convert.table_to_numpy(tmerge.materialize(arrs, hints="exhaustive",
                                                  device="cpu"))
    syncs = tmerge.host_syncs
    b = convert.table_to_numpy(tmerge.materialize(tens, hints="exhaustive",
                                                  device="cpu"))
    assert syncs > 0
    for f in tmerge.FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
