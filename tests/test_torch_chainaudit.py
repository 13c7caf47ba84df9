"""The port's trace audit (``crdt_graph_tpu_torch.utils.chainaudit``) and
what it feeds, on the CPU, held where it carries over against the JAX
reference.

The counter runs a function under a dispatch mode and counts what it
dispatched: memory passes (gathers, scatters, sorts, scans, a kernel
call as one) by width, host syncs by op name, by merge stage.  A kernel
wrapper's call is one row whatever it runs, so the CPU audit (the twins)
and the card audit give the same rows (the card side:
``tests/test_torch_cuda.py``).  Beside it: the flight recorder's
sampler (the reference's ``audit_due`` rule), the ops-axis audit (its
per-shard width within ceil(M/k) + halo), the runner's and the load
generator's audit keys, and ``profiling.timed`` / ``trace`` /
``table_stats``.
"""
import json
import os

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

torch.set_num_threads(1)

from crdt_graph_tpu.bench import workloads as jw  # noqa: E402
from crdt_graph_tpu.obs import flight as jflight  # noqa: E402
from crdt_graph_tpu.ops import merge as jmerge  # noqa: E402
from crdt_graph_tpu.utils import chainaudit as jaudit  # noqa: E402
from crdt_graph_tpu.utils import profiling as jprof  # noqa: E402

from crdt_graph_tpu_torch import convert, engine as tengine  # noqa: E402
from crdt_graph_tpu_torch.bench import loadgen as tloadgen  # noqa: E402
from crdt_graph_tpu_torch.bench import runner as trunner  # noqa: E402
from crdt_graph_tpu_torch.bench import workloads as tw  # noqa: E402
from crdt_graph_tpu_torch.codec import json_codec as tjson  # noqa: E402
from crdt_graph_tpu_torch.codec import packed as tpacked  # noqa: E402
from crdt_graph_tpu_torch.core import operation as top  # noqa: E402
from crdt_graph_tpu_torch.obs import flight as tflight  # noqa: E402
from crdt_graph_tpu_torch.ops import fused_resolve as tfr  # noqa: E402
from crdt_graph_tpu_torch.ops import merge as tmerge  # noqa: E402
from crdt_graph_tpu_torch.ops import mono_gather as tmg  # noqa: E402
from crdt_graph_tpu_torch.ops import tour_scan as tts  # noqa: E402
from crdt_graph_tpu_torch.parallel import opsaxis as topsaxis  # noqa: E402
from crdt_graph_tpu_torch.serve import ServingEngine  # noqa: E402
from crdt_graph_tpu_torch.utils import chainaudit  # noqa: E402
from crdt_graph_tpu_torch.utils import profiling as tprof  # noqa: E402

N = 1024
# the compact widths cut for a 4,096-op batch so it takes the branches a
# 1M batch takes, below the M-wide threshold: the sibling sort at M/16
# (S_CAP at 1M), the run pipeline at a width that holds config 5's runs
# (its second level, R_CAP2 = 4,096, at 1M)
SCALED_CAPS = {"GRAFT_S_CAP": "256", "GRAFT_S_CAP2": "16",
               "GRAFT_R_CAP": "256", "GRAFT_R_CAP2": "256"}


def _rng():
    return np.random.default_rng(0)


def _vec(n=N, hi=N):
    return torch.from_numpy(_rng().integers(0, hi, n).astype(np.int64))


# one memory pass each (class, function of (a, idx)), at width N
PASSES = {
    "index": ("gather", lambda a, i: a[i]),
    "index_select": ("gather", lambda a, i: torch.index_select(a, 0, i)),
    "gather": ("gather", lambda a, i: torch.gather(a, 0, i)),
    "take": ("gather", lambda a, i: torch.take(a, i)),
    "index_put_": ("scatter", lambda a, i: a.clone().index_put_((i,), a)),
    "scatter_": ("scatter", lambda a, i: a.clone().scatter_(0, i, a)),
    "scatter_reduce_": ("scatter", lambda a, i: a.clone().scatter_reduce_(
        0, i, a, "amin")),
    "index_add_": ("scatter", lambda a, i: a.clone().index_add_(0, i, a)),
    "index_reduce_": ("scatter", lambda a, i: a.clone().index_reduce_(
        0, i, a, "amax")),
    "sort": ("sort", lambda a, i: torch.sort(a, stable=True)),
    "argsort": ("sort", lambda a, i: torch.argsort(a)),
    "cumsum": ("scan", lambda a, i: torch.cumsum(a, 0)),
    "cummax": ("scan", lambda a, i: torch.cummax(a, 0)),
    "cummin": ("scan", lambda a, i: torch.cummin(a, 0)),
    "cumprod": ("scan", lambda a, i: torch.cumprod(a, 0)),
}


@pytest.mark.parametrize("name", sorted(PASSES))
def test_counter_counts_each_memory_pass(name):
    """Every gather, scatter, sort and scan is one M-wide pass at its
    width (the reference's counted primitives); it is counted below the
    threshold as a compacted pass, and not at all below the floor."""
    klass, fn = PASSES[name]
    a, i = _vec(), _vec()
    audit = chainaudit.count_mwide(fn, a, i, threshold=N)
    assert audit.fast_path == 1 and audit.static == 1, audit.table()
    counted = [r for r in audit.rows if chainaudit._klass(r[1])]
    assert [chainaudit._klass(r[1]) for r in counted] == [klass]
    assert counted[0][2] == N
    assert audit.host_syncs == 0 and audit.merges == 0
    compact = chainaudit.count_mwide(fn, a, i, threshold=2 * N,
                                     compact_floor=N)
    assert compact.fast_path == 0 and compact.compact_fast == 1
    below = chainaudit.count_mwide(fn, a, i, threshold=4 * N,
                                   compact_floor=2 * N)
    assert below.fast_path == below.compact_fast == 0


def test_counter_skips_elementwise_reductions_and_views():
    """Elementwise chains, reductions, slices and views are device ops
    (views not even that), never memory passes (reference
    ``test_counter_basics``); the default threshold is a quarter of the
    widest argument."""
    def cheap(a, idx):
        for _ in range(5):
            a = (a * 3) ^ (a + 1)
        return torch.sum(a) + a[:16].sum() + torch.max(idx) + a[None].sum()

    a, i = _vec(), _vec()
    audit = chainaudit.count_mwide(cheap, a, i)
    assert audit.threshold == N // 4 and audit.compact_floor == N // 64
    assert audit.fast_path == audit.static == audit.compact_fast == 0
    assert audit.device_ops == 22          # 15 + 4 reductions + 3 adds
    views = [r for r in audit.rows if r[2] == 0 and r[3] == 0]
    assert {r[1] for r in views} == {"slice", "unsqueeze"}


def _kernel_args():
    rng = _rng()
    plane = torch.from_numpy(rng.integers(-9, 9, (N, 3)))
    idx = torch.from_numpy(rng.integers(-N, 2 * N, 700).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 2, 900).astype(np.int32))
    w = torch.from_numpy(rng.integers(0, 2, (2, N)).astype(np.int32))
    vals = torch.from_numpy(rng.integers(0, 9, (4, N)).astype(np.int32))
    rid = torch.sort(idx.clamp(0, N - 1)).values
    ring = [torch.from_numpy(rng.integers(-9, 9, 3).astype(np.int32))
            for _ in range(8)]
    return {"plane_rows": (tfr, (plane, idx), 700),
            "plane_rows2": (tfr, (plane, idx, 1), 700),
            "prefix_sums": (tts, (b, w), N),
            "monotone_gather": (tmg, (vals, rid), 700),
            "ring_exclusive": (tts, (ring,), 3)}


@pytest.mark.parametrize("name", sorted(_kernel_args()))
def test_kernel_call_is_one_row_with_its_twin_suppressed(name):
    """A wrapper's call is ONE row named after it (width: its longest
    output axis), with none of the twin's own ops — so the CPU audit
    counts what the card audit counts; kernel 5 is the carry exchange,
    billed as a collective, not as a memory pass."""
    mod, args, width = _kernel_args()[name]
    fn = getattr(mod, name)
    audit = chainaudit.count_mwide(fn, *args, threshold=1)
    assert [r[1] for r in audit.rows] == [name]
    assert audit.rows[0][2] == width
    assert audit.kernel_calls == {name: 1}
    assert audit.device_ops == 1
    if name == "ring_exclusive":
        assert audit.fast_path == 0 and audit.collective_count == 1
        assert audit.collective_bytes == 2 * 8 * 3 * 4
    else:
        assert audit.fast_path == 1 and audit.collective_count == 0


def _d2h_copy():
    """A card → host copy, as the op classifier sees it (a meta tensor
    stands for the card's)."""
    src = torch.empty(4, device="meta")
    return chainaudit._op_name("_to_copy", (src,), {}, torch.empty(4))


SYNCS = {
    "item": (lambda x: x.sum().item(), "_local_scalar_dense"),
    "nonzero": (lambda x: torch.nonzero(x), "nonzero"),
    "where1": (lambda x: torch.where(x > 3), "nonzero"),
    "mask_index": (lambda x: x[x > 3], "index[mask]"),
    "mask_put": (lambda x: x.clone().__setitem__(x > 3, 0), "index_put_[mask]"),
    "masked_select": (lambda x: torch.masked_select(x, x > 3),
                      "masked_select"),
    "unique": (lambda x: torch.unique(x), None),
    "repeat_interleave": (lambda x: torch.repeat_interleave(x % 3),
                          "repeat_interleave"),
}


@pytest.mark.parametrize("name", sorted(SYNCS))
def test_sync_classification(name):
    """The ops that wait for the card — a scalar read, a data-sized
    output, a boolean mask — are host syncs by name on either device;
    outside ``merge._read`` every one is hidden."""
    fn, op = SYNCS[name]
    audit = chainaudit.count_mwide(fn, torch.arange(10))
    syncs = [r[1] for r in audit.rows if chainaudit._is_sync(r[1])]
    assert len(syncs) == 1, audit.rows
    if op is not None:
        assert syncs == [op]
    assert audit.host_syncs == audit.hidden_syncs == 1


def test_sync_classification_copies_and_sized_outputs():
    """A copy to the host is a sync, one from the host and a
    ``repeat_interleave`` told its output size are not, and a read
    through ``merge._read`` is counted there, so it is not hidden."""
    assert _d2h_copy() == "_to_copy[d2h]" and chainaudit._is_sync(_d2h_copy())
    h2d = chainaudit._op_name("_to_copy", (torch.empty(4),), {},
                              torch.empty(4, device="meta"))
    assert h2d == "_to_copy[h2d]" and not chainaudit._is_sync(h2d)
    x = torch.arange(4)
    sized = chainaudit.count_mwide(
        lambda v: torch.repeat_interleave(v, v, output_size=6), x)
    assert sized.host_syncs == 0
    before = tmerge.host_syncs
    read = chainaudit.count_mwide(lambda v: tmerge._read(v.sum() > 2), x)
    assert tmerge.host_syncs == before + 1
    assert read.host_syncs == read.read_syncs == 1
    assert read.hidden_syncs == 0


# config 5 at 4,096 ops with SCALED_CAPS, per stage: device ops, memory
# passes outside loops and in them, kernel calls, ``merge._read`` syncs
# and hidden ones (the same counts as at 65,536 ops with the default
# widths)
PINNED_4096 = {
    1: dict(device_ops=28, mwide=0, loop_ops=0, kernel_calls=0,
            read_syncs=0, hidden_syncs=0),
    2: dict(device_ops=120, mwide=1, loop_ops=0, kernel_calls=1,
            read_syncs=0, hidden_syncs=0),
    3: dict(device_ops=24, mwide=0, loop_ops=0, kernel_calls=0,
            read_syncs=2, hidden_syncs=0),
    4: dict(device_ops=3, mwide=0, loop_ops=0, kernel_calls=0,
            read_syncs=0, hidden_syncs=0),
    5: dict(device_ops=129, mwide=4, loop_ops=0, kernel_calls=0,
            read_syncs=3, hidden_syncs=0),
    6: dict(device_ops=120, mwide=2, loop_ops=0, kernel_calls=2,
            read_syncs=9, hidden_syncs=0),
    7: dict(device_ops=54, mwide=2, loop_ops=0, kernel_calls=0,
            read_syncs=1, hidden_syncs=0),
}


@pytest.fixture()
def scaled_caps(monkeypatch):
    for k, v in SCALED_CAPS.items():
        monkeypatch.setenv(k, v)


def test_config5_4096_within_budget(scaled_caps):
    """Config 5 at 4,096 ops with the compact widths scaled as at 1M: the
    vouched merge's fast path and host syncs within the budgets, every
    sync a counted ``merge._read`` (``merge.host_syncs`` agrees), the
    crowding leg the reference's, and the counts by stage pinned."""
    arrs = tw.chain_workload(64, 4096)
    before = tmerge.host_syncs
    audit = chainaudit.audit_materialize(arrs, "exhaustive", True, "cpu")
    s = audit.summary()
    assert s["ok"] and \
        audit.fast_path <= chainaudit.FAST_PATH_BUDGETS["slot"][0], \
        audit.table()
    assert audit.fast_syncs <= chainaudit.SYNC_BUDGET
    assert audit.hidden_syncs == 0
    assert audit.read_syncs == tmerge.host_syncs - before
    assert audit.legs == ["slot"] and audit.merges == 1
    assert audit.kernel_calls == {"plane_rows2": 1, "prefix_sums": 1,
                                  "monotone_gather": 1}
    ref = jaudit.audit_materialize(jw.chain_workload(64, 4096),
                                   "exhaustive", True)
    assert s["crowding_leg"] == ref.crowding_leg
    assert audit.by_stage() == PINNED_4096, json.dumps(audit.by_stage())


def test_syncs_outside_the_merge_are_the_callers():
    """A sync around a merge (a caller's read-back) is an ``outer_sync``:
    in ``host_syncs``, not held to the merge's sync budget; with no merge
    in the run every sync outside a loop is held."""
    arrs = tw.chain_workload(64, 4096)
    cols = convert.ops_from_numpy(arrs, "cpu")
    merge_only = chainaudit.count_mwide(
        lambda c: tmerge._materialize(c, "exhaustive", torch.device("cpu"),
                                      True), cols)
    def with_reads(c):
        t = tmerge._materialize(c, "exhaustive", torch.device("cpu"), True)
        for _ in range(3):
            t.status.sum().item()
    audit = chainaudit.count_mwide(with_reads, cols)
    assert audit.outer_syncs == 3 and merge_only.outer_syncs == 0
    assert audit.fast_syncs == merge_only.fast_syncs
    assert audit.host_syncs == merge_only.host_syncs + 3
    assert audit.summary()["outer_syncs"] == 3
    bare = chainaudit.count_mwide(lambda x: x.sum().item(), _vec())
    assert bare.fast_syncs == 1 and bare.outer_syncs == 0


@pytest.mark.parametrize("deletes", [False, True])
def test_audit_leaves_the_merge_unchanged(deletes):
    """The audited merge's table equals the plain merge's field for
    field: the audit only watches."""
    arrs = tw.chain_with_deletes(4096, 16, 64) if deletes else \
        tw.chain_workload(64, 4096)
    cols = convert.ops_from_numpy(arrs, "cpu")
    plain = convert.table_to_numpy(
        tmerge._materialize(cols, "exhaustive", torch.device("cpu"),
                            not deletes))
    with chainaudit.Audit() as a:
        seen = convert.table_to_numpy(
            tmerge._materialize(cols, "exhaustive", torch.device("cpu"),
                                not deletes))
    for f in tmerge.FIELDS:
        np.testing.assert_array_equal(seen[f], plain[f], err_msg=f)
    assert a.result().merges == 1


def test_audit_over_budget_counts_a_failure_and_dumps(tmp_path, monkeypatch):
    """A sampled commit whose merge passes the budget says ``ok: false``,
    which counts an audit failure and dumps the ring (reference
    ``flight.py`` :191-192); the budget is cut below this merge's
    passes."""
    monkeypatch.setattr(chainaudit, "FAST_PATH_BUDGETS",
                        dict.fromkeys(chainaudit.FAST_PATH_BUDGETS, (1, 1)))
    rec = tflight.FlightRecorder(dump_dir=str(tmp_path), audit_every=1,
                                 audit_min_ops=4096)
    eng = ServingEngine(device="cpu", flight=rec)
    try:
        p = tw.chain_workload(64, 4096)
        wire = tengine.packed_since_bytes(_packed(p, 4096), 0)
        assert eng.submit("d", wire)[0]
        assert eng.flush(60)
    finally:
        eng.close()
    (r,) = [r for r in rec.records() if r.doc_id == "d"]
    assert r.audit["ok"] is False and "sample_error" not in r.audit
    assert r.audit["merges"] == 1 and r.audit["batch_width"] is None
    assert rec.stats()["audit_failures"] == 1
    assert any(n.endswith("_audit.jsonl") for n in os.listdir(tmp_path))
    assert "audit_sample" in r.stages_ms


def test_sampled_commit_carries_its_own_merges_audit(scaled_caps):
    """``GRAFT_OBS_AUDIT_EVERY`` > 0 arms the sampler: a due commit's own
    merge runs under the audit (no second merge) and its flight record
    carries the summary, ``ok`` at production-scaled widths; a commit
    that is not due carries none."""
    rec = tflight.FlightRecorder(audit_every=2, audit_min_ops=4096)
    eng = ServingEngine(device="cpu", flight=rec)
    try:
        for doc in ("a", "b", "c"):
            wire = tengine.packed_since_bytes(
                _packed(tw.chain_workload(64, 4096), 4096), 0)
            assert eng.submit(doc, wire)[0]
            assert eng.flush(60)
    finally:
        eng.close()
    got = {r.doc_id: r.audit for r in rec.records()}
    assert got["b"] is None
    for doc in ("a", "c"):
        assert got[doc]["ok"], got[doc]
        assert got[doc]["merges"] == 1 and got[doc]["legs"] == ["slot"]
        assert got[doc]["kernel_calls"]["prefix_sums"] == 1


def test_sampled_commits_on_a_document_with_deletes_pass(scaled_caps):
    """A document that has had deletes: its sampled commits run the
    merge's delete stage (a vouched batch of adds and deletes, then a
    wire batch of adds merged with the whole log), and each is held to
    its leg's delete-stage budget — ``ok``, no audit failure."""
    rec = tflight.FlightRecorder(audit_every=1, audit_min_ops=4096)
    eng = ServingEngine(device="cpu", flight=rec)
    arrs = tw.chain_with_deletes(4096, 16, 64)
    n = arrs["kind"].shape[0]
    last = int(arrs["ts"][4095])
    adds = [top.Add(200 * 2**32 + c, (last if c == 1 else
                                      200 * 2**32 + c - 1,), f"r{c}")
            for c in range(1, 4097)]
    try:
        for wire in (tengine.packed_since_bytes(_packed(arrs, n), 0),
                     tjson.dumps(top.Batch(tuple(adds)))):
            assert eng.submit("d", wire)[0]
            assert eng.flush(60)
        assert len(eng.get("d").snapshot_view().visible_values()) == \
            4096 - 256 + 4096
    finally:
        eng.close()
    got = [r.audit for r in rec.records() if r.doc_id == "d"]
    assert len(got) == 2 and all(a is not None for a in got)
    for a in got:
        # the engine's ingest: the log and the delta on the slot leg
        assert a["ok"] and a["deletes"] and a["legs"] == ["slot"], a
        assert a["budget"] == chainaudit.FAST_PATH_BUDGETS["slot"][1]
    assert rec.stats()["audit_failures"] == 0


def _packed(arrs, n):
    return tpacked.PackedOps(
        kind=arrs["kind"], ts=arrs["ts"], parent_ts=arrs["parent_ts"],
        anchor_ts=arrs["anchor_ts"], depth=arrs["depth"],
        paths=arrs["paths"], value_ref=arrs["value_ref"], pos=arrs["pos"],
        values=list(range(n)), num_ops=n, parent_pos=arrs["parent_pos"],
        anchor_pos=arrs["anchor_pos"], target_pos=arrs["target_pos"],
        ts_rank=arrs["ts_rank"], hints_vouched=True)


def test_audit_due_sequence_equals_reference():
    """The sampler's rule is the reference's: every ``audit_every``th
    record, only at ``num_ops >= audit_min_ops`` — the same record
    stream gives the same sampled sequence."""
    stream = [5, 70_000, 65_536, 10, 1 << 20, 65_535, 65_536, 200_000,
              3, 65_536, 65_536, 90_000, 1, 70_000]
    seqs = []
    for mod in (jflight, tflight):
        rec = mod.FlightRecorder(audit_every=3, audit_min_ops=65_536,
                                 slo_ms=0)
        seq = []
        for n in stream:
            seq.append(rec.audit_due(n))
            rec.record(dict(
                doc_id="d", trace_ids=(), outcome="committed", num_ops=n,
                applied_ops=n, dup_ops=0, coalesce_width=1, chunk_count=1,
                queue_depth_admission=0, stages_ms={}, total_ms=1.0,
                staleness_s=None, snapshot_seq=None, fingerprint=None))
        seqs.append(seq)
    assert seqs[0] == seqs[1] and any(seqs[1])
    assert tflight.FlightRecorder(audit_every=0).audit_due(1 << 20) is False


@pytest.mark.parametrize("k", [2, 4, 8])
def test_audit_opsaxis_shard_width_within_budget(k):
    """The ops-axis audit at k logical shards: the widest memory pass
    inside a shard's window is at least ceil(M/k) (the shards' own
    frames) and within ceil(M/k) + halo (reference
    ``tests/test_chain_audit.py``); the carry exchange is kernel 5's
    calls; the crowding leg is the single merge's."""
    n = 65_536
    st = topsaxis.audit_opsaxis(tw.chain_workload(64, n), k=k, device="cpu")
    m = n + 2
    assert st["devices"] == k
    assert st["shard_budget"] == -(-m // k) + topsaxis.HALO
    assert -(-m // k) <= st["shard_width"] <= st["shard_budget"], st
    assert st["ok"] and st["collective_count"] >= 1
    assert st["collective_bytes"] > 0
    assert st["leg"] == "hinted"
    assert set(st) == {"devices", "shard_width", "shard_budget",
                       "halo_rows", "collective_bytes", "collective_count",
                       "leg", "ok"}


def test_loadgen_opsaxis_block_carries_the_last_routed_audit(monkeypatch):
    """The load generator's ``opsaxis`` block: the routing counters, and
    the audit of the sharded merge sampled once a run armed it (None
    before, and a merge that was not armed keeps nothing; the key is
    always there)."""
    monkeypatch.setattr(topsaxis, "_STATS",
                        {"merges": 0, "devices": 0, "routed_ops": 0})
    monkeypatch.setattr(topsaxis, "_AUDIT", {"armed": False, "last": None})
    assert tloadgen._opsaxis_report()["audit"] is None
    arrs = tw.chain_workload(64, 8192)
    plain = topsaxis.materialize(arrs, k=4, hints="exhaustive", device="cpu")
    assert tloadgen._opsaxis_report()["audit"] is None
    topsaxis.arm_audit()
    seen = topsaxis.materialize(arrs, k=4, hints="exhaustive", device="cpu")
    out = tloadgen._opsaxis_report()
    assert out["merges"] == 2 and out["devices"] == 4
    assert out["audit"]["devices"] == 4 and out["audit"]["ok"]
    assert out["audit"] == topsaxis.audit_opsaxis(arrs, k=4, device="cpu")
    # one merge an arming; the audited merge's table is the plain one's
    assert topsaxis._AUDIT["armed"] is False
    for f in tmerge.FIELDS:
        np.testing.assert_array_equal(getattr(seen, f).numpy(),
                                      getattr(plain, f).numpy(), err_msg=f)
    # the record holds no columns, only the counts
    assert all(not isinstance(v, (np.ndarray, torch.Tensor, dict))
               for v in out["audit"].values())


def test_runner_row_carries_the_audit_keys():
    """A runner row carries ``chain_audit`` (the summary of one more
    merge, outside the timed repeats) and ``opsaxis``, without error."""
    row = trunner.time_merge(tw.chain_workload(64, 4096), repeats=1,
                             audit=False, hints="exhaustive", device="cpu")
    ca = row["chain_audit"]
    assert "error" not in ca and "error" not in row["opsaxis"]
    assert ca["merges"] == 1 and ca["legs"] == ["slot"]
    want = jmerge.crowding_hinted(jw.chain_workload(64, 4096), "exhaustive",
                                  True)
    assert ca["crowding_leg"] == row["opsaxis"]["leg"] == \
        ("hinted" if want else "counted")
    assert ca["kernel_calls"]["monotone_gather"] == 1


def test_timed_keys_equal_reference():
    """``profiling.timed`` returns the reference's stats keys and the
    last result read back to the host."""
    jstats, _ = jprof.timed(lambda: jax.numpy.ones(3), repeats=2)
    stats, out = tprof.timed(lambda: torch.ones(3) * 2, repeats=2)
    assert sorted(stats) == sorted(jstats)
    assert all(v >= 0 for v in stats.values())
    assert isinstance(out, np.ndarray) and out.tolist() == [2.0] * 3
    # a NodeTable result comes back with its fields on the host
    _, t = tprof.timed(lambda: tmerge.materialize(
        tw.chain_workload(8, 256), hints="exhaustive", device="cpu"),
        repeats=1)
    assert isinstance(t.order, np.ndarray)


def test_trace_writes_a_chrome_trace(tmp_path):
    """``profiling.trace`` is a ``torch.profiler`` session that leaves a
    Chrome trace in the directory."""
    with tprof.trace(str(tmp_path / "tr")) as prof:
        torch.cumsum(torch.arange(100), 0)
    files = os.listdir(tmp_path / "tr")
    assert files == [os.path.basename(prof.trace_path)]
    with open(prof.trace_path) as f:
        assert "traceEvents" in json.load(f)


@pytest.mark.parametrize("deletes", [False, True])
def test_table_stats_equal_reference(deletes):
    """``table_stats`` of the port's table equals the reference's of the
    reference's table for the same columns."""
    arrs = jw.chain_with_deletes(4096, 16, 8) if deletes else \
        jw.chain_workload(8, 4096)
    want = jprof.table_stats(jmerge.materialize(arrs, hints="exhaustive"))
    got = tprof.table_stats(tmerge.materialize(arrs, hints="exhaustive",
                                               device="cpu"))
    assert got == want
    assert got["tombstones"] == (256 if deletes else 0)
