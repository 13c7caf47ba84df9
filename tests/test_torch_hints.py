"""Every hint mode and resolution leg of the port's merge against the JAX
reference, on the CPU.

The same numpy columns go through ``crdt_graph_tpu.ops.merge.materialize(
..., hints=mode)`` and ``crdt_graph_tpu_torch.ops.merge.materialize(...,
hints=mode, device="cpu")``; every ``NodeTable`` field must be equal,
dtype included (integer data: exact).  The legs:

- slot-hinted: vouched arrays under ``"exhaustive"``;
- ranked and verified: vouched arrays under ``None``/``"auto"``;
- link-only: the position hints without ``ts_rank``;
- hint-free: no hint columns, or ``"join"``;

and the corrupt-hint fallbacks, each counted in ``merge.fallbacks``.
"""
import dataclasses
import random

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

torch.set_num_threads(1)

import crdt_graph_tpu as crdt  # noqa: E402
from crdt_graph_tpu import Add, Delete  # noqa: E402
from crdt_graph_tpu.bench import workloads as jw  # noqa: E402
from crdt_graph_tpu.codec import packed as jpacked  # noqa: E402
from crdt_graph_tpu.core import operation as jop  # noqa: E402
from crdt_graph_tpu.ops import merge as jmerge  # noqa: E402
from crdt_graph_tpu.ops import view as jview  # noqa: E402

from crdt_graph_tpu_torch import convert  # noqa: E402
from crdt_graph_tpu_torch.ops import merge as tmerge  # noqa: E402

MODES = (None, "auto", "exhaustive", "join")
RANK_COLS = ("ts_rank",) + jpacked.SLOT_HINT_COLS + jpacked.CROWD_HINT_COLS
PROBES = (1, 2, 3, 4, 5, 6, 7)


def _configs():
    """Configs 1-8 at reduced size (1 and 4 carry deletes, 3 and 8 nest),
    as vouched arrays with the derived slot hints."""
    return {
        1: lambda: jpacked.pack(jw.editor_replay(400)).arrays(),
        2: lambda: jpacked.pack(jw.two_replica_interleaved(800)).arrays(),
        3: lambda: jpacked.pack(jw.nested_tree(1500, 4)).arrays(),
        4: lambda: jpacked.pack(jw.tombstone_heavy(600, 8)).arrays(),
        5: lambda: jw.chain_workload(4, 2048),
        6: lambda: jw.descending_chains(64, 2048),
        7: lambda: jw.comb_pairs(2048),
        8: lambda: jw.deep_paths(8, 2048),
    }


def _link_only(arrs):
    return {k: v for k, v in arrs.items() if k not in RANK_COLS}


def _hint_free(arrs):
    return {k: v for k, v in arrs.items() if k in tmerge.BASE_COLS}


def _both(arrs, hints):
    """Both packages' tables for one mode, and the port's fallback count."""
    jt = jview.to_host(jmerge.materialize(arrs, hints=hints))
    tmerge.fallbacks = 0
    tt = tmerge.materialize(arrs, hints=hints, device="cpu")
    return jt, convert.table_to_numpy(tt), tmerge.fallbacks


def _assert_equal(jt, got, tag):
    for f in tmerge.FIELDS:
        want = np.asarray(getattr(jt, f))
        assert got[f].dtype == want.dtype, f"{tag}: field {f} dtype"
        np.testing.assert_array_equal(got[f], want,
                                      err_msg=f"{tag}: field {f}")


def _assert_same_table(a, b, tag):
    for f in tmerge.FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{tag}: {f}")


@pytest.mark.parametrize("hints", MODES, ids=lambda h: str(h))
@pytest.mark.parametrize("cid", range(1, 9))
def test_configs_every_mode_match(cid, hints):
    """Vouched arrays: slot-hinted under exhaustive, ranked and verified
    under None/auto (no fallback: the hints are right), sort+join under
    join — each equal to the reference's same mode."""
    arrs = _configs()[cid]()
    jt, got, fb = _both(arrs, hints)
    _assert_equal(jt, got, f"config {cid} hints={hints}")
    assert fb == 0


@pytest.mark.parametrize("hints", MODES, ids=lambda h: str(h))
@pytest.mark.parametrize("cid", [1, 3])
def test_link_only_and_hint_free_legs_match(cid, hints):
    """Without ``ts_rank`` the link-hinted leg runs (sorted slots, hinted
    links, the join only on a miss); without any hint column every mode
    is the sort+join.  Both equal the reference and the join."""
    arrs = _configs()[cid]()
    ref = _both(arrs, "join")[1]
    for tag, cut in (("link", _link_only(arrs)), ("bare", _hint_free(arrs))):
        jt, got, fb = _both(cut, hints)
        _assert_equal(jt, got, f"config {cid} {tag} hints={hints}")
        _assert_same_table(got, ref, f"config {cid} {tag} vs join")
        assert fb == 0


def _corrupt_cases():
    """(name, arrays, config) — each a single wrong hint the verified
    modes must catch."""
    out = []
    a5 = _configs()[5]()
    r = a5["ts_rank"].copy()
    adds = np.nonzero(r >= 0)[0]
    r[adds[3]], r[adds[700]] = r[adds[700]], r[adds[3]]
    out.append(("swapped_ts_rank", dict(a5, ts_rank=r)))
    a3 = _configs()[3]()
    pp = a3["parent_pos"].copy()
    rows = np.nonzero(pp >= 0)[0]
    pp[rows[10]] = (pp[rows[10]] + 1) % len(pp)    # a wrong row
    out.append(("wrong_parent_pos", dict(a3, parent_pos=pp)))
    # a reference to a timestamp outside the batch with a hint that
    # points at some add row (verify_hints property (c))
    p = jpacked.pack([Add(1, (0,), "a"), Add(2, (1,), "b"),
                      Add(6, (5, 0), "x"), Add(7, (2,), "c")])
    arrs = p.arrays()
    sp = arrs["parent_pos"].copy()
    sp[2] = 0
    out.append(("stray_out_of_batch", dict(arrs, parent_pos=sp)))
    return out


@pytest.mark.parametrize("case", range(3),
                         ids=["swapped_ts_rank", "wrong_parent_pos",
                              "stray_out_of_batch"])
def test_corrupt_hints_fall_back(case):
    """One wrong hint: None and auto verify it, fall back once to the
    sort+join and equal ``join``, as in the reference; the fallback is
    counted once per merge."""
    name, arrs = _corrupt_cases()[case]
    ref = _both(arrs, "join")
    _assert_equal(ref[0], ref[1], f"{name} join")
    for hints in (None, "auto"):
        jt, got, fb = _both(arrs, hints)
        _assert_equal(jt, got, f"{name} hints={hints}")
        _assert_same_table(got, ref[1], f"{name} hints={hints} vs join")
        assert fb == 1, (name, hints)


def test_stale_slot_hint_default_matches_reference():
    """The default mode is the reference's verified auto mode, which
    never reads slot hints: a batch whose slot hint is stale (one
    ``parent_sl`` pointing at a wrong slot) merges right under the
    default call of each package — the same table as ``join`` — and
    takes no fallback, since the position and rank hints are right."""
    arrs = _configs()[3]()
    psl = arrs["parent_sl"].copy()
    rows = np.nonzero(arrs["depth"] >= 2)[0]
    psl[rows[5]] = ((psl[rows[5]] >> 1) + 3) << 1 | 1
    bad = dict(arrs, parent_sl=psl)
    ref = _both(bad, "join")[1]
    jt = jview.to_host(jmerge.materialize(bad))
    tmerge.fallbacks = 0
    got = convert.table_to_numpy(tmerge.materialize(bad, device="cpu"))
    assert tmerge.fallbacks == 0
    _assert_equal(jt, got, "stale parent_sl, default mode")
    _assert_same_table(got, ref, "stale parent_sl, default vs join")
    # the vouched mode trusts the slot hint and resolves differently
    ex = convert.table_to_numpy(tmerge.materialize(bad, hints="exhaustive",
                                                   device="cpu"))
    assert any(not np.array_equal(ex[f], ref[f]) for f in tmerge.FIELDS)


@pytest.mark.parametrize("hints", ["auto", "join"])
@pytest.mark.parametrize("corrupt", [False, True])
def test_probe_checksums_match(hints, corrupt):
    """The probe cuts 1-7 under auto and join return the
    reference's cumulative checksums — on right hints, and on a swapped
    rank that sends auto down the fallback."""
    arrs = _corrupt_cases()[0][1] if corrupt else _configs()[5]()
    nd = jmerge.host_no_deletes(arrs["kind"])
    for k in PROBES:
        want = int(jmerge._materialize(arrs, None, hints, nd, k))
        got = tmerge.materialize(arrs, hints=hints, device="cpu", probe=k)
        assert got == want, f"hints={hints} corrupt={corrupt} probe {k}"


def test_probe_checksums_match_with_deletes():
    arrs = _link_only(_configs()[4]())
    nd = jmerge.host_no_deletes(arrs["kind"])
    for k in PROBES:
        want = int(jmerge._materialize(arrs, None, "auto", nd, k))
        assert tmerge.materialize(arrs, hints="auto", device="cpu",
                                  probe=k) == want, f"probe {k}"


# -- the sort+join construction, piece by piece -------------------------

def _sort_inputs():
    """Equal timestamps, duplicates, zeros, non-adds, BIG and beyond."""
    big = tmerge.BIG
    ts = np.array([5, 3, 5, 0, big, 7, 3, 3, big + 9, 1, 7, 2**40, 5, 0],
                  np.int64)
    kind = np.array([0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 2, 1], np.int8)
    pos = np.arange(ts.size, dtype=np.int32)
    return kind, ts, pos


def test_sorted_slots_match_reference():
    """The stable int64 sort replaces the reference's stable (hi, lo)
    sort: the same slots, duplicate flags, canonical rows and node
    columns, and the same sorted axis."""
    import jax.numpy as jnp
    kind, ts, pos = _sort_inputs()
    n = ts.size
    m = n + 2
    want_slots, want_sorted = jmerge._sorted_slots_impl(
        jnp.asarray(kind == 0), jnp.asarray(ts), jnp.asarray(pos),
        n, m, 0, m - 1)
    got_slots, got_sorted = tmerge._sorted_slots(
        torch.from_numpy(kind == 0), torch.from_numpy(ts),
        torch.from_numpy(pos), n, m)
    np.testing.assert_array_equal(got_sorted.numpy(), np.asarray(want_sorted))
    for i, (g, w) in enumerate(zip(got_slots, want_slots)):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, i
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(i))


def test_join_matches_reference():
    import jax.numpy as jnp
    kind, ts, pos = _sort_inputs()
    n = ts.size
    m = n + 2
    _, s = jmerge._sorted_slots_impl(jnp.asarray(kind == 0),
                                     jnp.asarray(ts), jnp.asarray(pos),
                                     n, m, 0, m - 1)
    sorted_ts = np.array(s)
    q1 = np.array([0, 3, 4, 5, tmerge.BIG, 2**40, 7, 99, 1, 0, 3, 2**41,
                   -1, 5], np.int64)
    q2 = q1[::-1].copy()
    want = jmerge._join_ops_impl(jnp.asarray(sorted_ts), jnp.asarray(q1),
                                 jnp.asarray(q2), n, 0, m - 1)
    got = tmerge._join_ops(torch.from_numpy(sorted_ts), torch.from_numpy(q1),
                           torch.from_numpy(q2), n, m)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.numpy().dtype == np.asarray(w).dtype


def test_canon_pos_equals_cummax():
    """The run-start construction equals ``torch.cummax`` of the run-start
    indices (the reference's ``lax.cummax``) on random sorted axes."""
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 1000):
        s = np.sort(rng.integers(0, max(2, n // 3), n)).astype(np.int64)
        t = torch.from_numpy(s)
        rs = torch.cat([torch.ones(1, dtype=torch.bool), t[1:] != t[:-1]])
        ar = torch.arange(n, dtype=torch.int32)
        want = torch.cummax(torch.where(rs, ar, 0), 0).values
        c = torch.cumsum(rs.to(torch.int32), 0, dtype=torch.int32)
        starts = tmerge.set_drop(torch.zeros(n, dtype=torch.int32),
                                 torch.where(rs, c - 1, n), ar)
        np.testing.assert_array_equal(starts[(c - 1).long()].numpy(),
                                      want.numpy())


# -- the hint cases of the reference's merge-kernel suite ----------------

def _random_session(seed, n_replicas=3, steps=70):
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


def test_mislinked_hints_fall_back_to_join():
    """Every resolvable hint pointing at op 0: auto verifies, falls back,
    and equals the reference."""
    _, ops = _random_session(22, steps=60)
    arrs = dict(jpacked.pack(ops).arrays())
    for k in ("parent_pos", "anchor_pos", "target_pos"):
        bad = np.asarray(arrs[k]).copy()
        bad[bad >= 0] = 0
        arrs[k] = bad
    jt, got, fb = _both(arrs, None)
    _assert_equal(jt, got, "mislinked")
    assert fb == 1


def test_missing_anchor_modes_agree():
    """A genuinely missing anchor: auto takes the join at run time,
    exhaustive resolves to not-found directly; same tables as the
    reference in every mode."""
    _, ops = _random_session(33)
    ops = ops + [Add(77 * 2**32 + 1, (12345,), "orphan")]
    arrs = jpacked.pack(ops).arrays()
    tables = {}
    for h in MODES:
        jt, got, fb = _both(arrs, h)
        _assert_equal(jt, got, f"orphan hints={h}")
        assert fb == (1 if h in (None, "auto") else 0)
        tables[h] = got
    for h in MODES:
        _assert_same_table(tables[h], tables["join"], f"orphan {h}")


@pytest.mark.parametrize("how", ["shuffled", "collision", "gap", "missing",
                                 "oob", "all_missing"])
def test_hostile_ranks_fall_back(how):
    _, ops = _random_session(91, steps=60)
    base = jpacked.pack(ops).arrays()
    r = base["ts_rank"].copy()
    adds = np.nonzero(r >= 0)[0]
    rng = np.random.default_rng(5)
    if how == "shuffled":
        r[adds] = rng.permutation(r[adds])
    elif how == "collision":
        r[adds[1]] = r[adds[0]]
    elif how == "gap":
        r[adds] = r[adds] + 1
    elif how == "missing":
        r[adds[2]] = -1
    elif how == "oob":
        r[adds[0]] = 10**6
    else:
        r[:] = -1
    arrs = dict(base, ts_rank=r)
    jt, got, fb = _both(arrs, "auto")
    _assert_equal(jt, got, how)
    assert fb == 1
    _assert_same_table(got, _both(base, "join")[1], f"{how} vs join")


def test_hostile_pos_duplicate_winner_agrees():
    """A producer violating pos == array index: the ranked leg and the
    join elect the same canonical copy (first array row)."""
    p = jpacked.pack([Add(1, (0,), "first"), Add(1, (0,), "second"),
                      Add(2, (1,), "tail")])
    arrs = dict(p.arrays())
    hostile = np.asarray(arrs["pos"]).copy()
    hostile[0], hostile[1] = 1, 0
    arrs["pos"] = hostile
    rank = _both(arrs, None)
    join = _both(arrs, "join")
    _assert_equal(rank[0], rank[1], "ranked")
    _assert_equal(join[0], join[1], "join")
    # the legs lay slots out differently around a duplicate; the
    # document and the statuses agree
    for f in ("status", "num_visible"):
        np.testing.assert_array_equal(rank[1][f], join[1][f])
    vals = [p.values[rank[1]["value_ref"][s]] for s in
            rank[1]["visible_order"][:int(rank[1]["num_visible"])]]
    assert vals == [p.values[join[1]["value_ref"][s]] for s in
                    join[1]["visible_order"][:int(join[1]["num_visible"])]]
    assert vals == ["first", "tail"]


def test_high_low_half_timestamps_every_mode():
    """Counters past 2^31 (negative low int32 halves in the reference's
    split keys) in shuffled order: every mode agrees."""
    hi = 2**31
    off = 2**32
    ops = [Add(off + hi, (0,), "a"), Add(off + hi + 1, (off + hi,), "b"),
           Add(2 * off + 5, (0,), "c"),
           Add(2 * off + hi + 7, (2 * off + 5,), "d"),
           Add(off + 3, (0,), "e"), Delete((2 * off + 5,))]
    rng = random.Random(4)
    rng.shuffle(ops)
    arrs = jpacked.pack(ops).arrays()
    for h in MODES:
        jt, got, _ = _both(arrs, h)
        _assert_equal(jt, got, f"hints={h}")


def test_verify_hints_agrees_with_auto_verification():
    """The host audit and the device verification agree: a batch that
    fails ``verify_hints`` in one hint takes the fallback under auto."""
    p = jpacked.pack([Add(1, (0,), "a"), Add(2, (1,), "b"),
                      Add(3, (2,), "c"), Add(4, (1, 0), "d"),
                      Delete((2,))])
    assert jpacked.verify_hints(p)
    pp = p.parent_pos.copy()
    pp[3] = 2
    q = dataclasses.replace(p, parent_pos=pp)
    assert not jpacked.verify_hints(q)
    _, _, fb_ok = _both(p.arrays(), "auto")
    jt, got, fb_bad = _both(q.arrays(), "auto")
    _assert_equal(jt, got, "mislinked parent")
    assert (fb_ok, fb_bad) == (0, 1)
