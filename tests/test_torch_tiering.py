"""The port's tiered op log (hot tail → cold segments → chunked base) and
its scrub against the reference package's, on the CPU.

The same applied histories go into ``crdt_graph_tpu.oplog.OpLog`` /
``engine.TpuTree`` and ``crdt_graph_tpu_torch.oplog.OpLog`` /
``engine.TpuTree(device="cpu")``.  A tiered log must keep the untiered
object contract; its window bytes and meta must equal the untiered
``packed_since_window`` at every tier seam (and the reference's tiered
answers); truncation into the cold tier, checkpoint + tail restore,
fold, watermark-gated GC and byte-budget spills must behave as the
reference's; a corrupt segment or manifest must raise the typed
``CheckpointError``; and a flipped byte must scrub into quarantine, ride
the manifest across a restart, and heal from a healthy replica's rows.

The zip clock is frozen so segment files compare whole.
"""
import json
import os
import time
import types
import zipfile

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

torch.set_num_threads(1)

from crdt_graph_tpu import engine as jengine  # noqa: E402
from crdt_graph_tpu import oplog as joplog  # noqa: E402
from crdt_graph_tpu.codec import json_codec as jjson  # noqa: E402
from crdt_graph_tpu.codec import packed as jpacked  # noqa: E402
from crdt_graph_tpu.core.errors import \
    CheckpointError as JCheckpointError  # noqa: E402
from crdt_graph_tpu.core.operation import Add, Delete  # noqa: E402

from crdt_graph_tpu_torch import engine as tengine  # noqa: E402
from crdt_graph_tpu_torch import oplog as toplog  # noqa: E402
from crdt_graph_tpu_torch.codec import json_codec as tjson  # noqa: E402
from crdt_graph_tpu_torch.codec import packed as tpacked  # noqa: E402
from crdt_graph_tpu_torch.core import operation as top  # noqa: E402
from crdt_graph_tpu_torch.core.errors import CheckpointError  # noqa: E402
from crdt_graph_tpu_torch.ops import merge as tmerge  # noqa: E402


@pytest.fixture(autouse=True)
def frozen_zip_clock(monkeypatch):
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: 1_700_000_000.0, localtime=time.localtime))


def ts(r, c):
    return r * 2**32 + c


def chain_ops(r, n, start=1):
    out = []
    prev = ts(r, start - 1) if start > 1 else 0
    for c in range(start, start + n):
        out.append(Add(ts(r, c), (prev,), f"v{r}.{c}"))
        prev = ts(r, c)
    return out


def mixed_ops(n_per=40):
    """Two interleaved replica chains, a delete burst mid-log and an
    all-delete tail — the window-rule torture shape."""
    a, b = chain_ops(1, n_per), chain_ops(2, n_per)
    ops = [op for pair in zip(a, b) for op in pair]
    ops[n_per:n_per] = [Delete((ts(1, c),)) for c in range(3, 9)]
    ops.extend(Delete((ts(2, c),)) for c in range(n_per - 4, n_per + 1))
    return ops


def port(ops):
    return [tjson.loads(jjson.dumps(o)) for o in ops]


def applied_log(ops):
    """The applied history of ``ops`` (through a reference replica, so
    deletes are validated), as reference objects."""
    t = jengine.init(0)
    for op in ops:
        t.apply(op)
    return list(t._log)


def tiered_pair(applied, tmp_path, name, **kw):
    """The same history in a tiered port log and a tiered reference log,
    fully spilled under the hot budget (no folding unless asked)."""
    kw.setdefault("hot_ops", 16)
    kw.setdefault("gc_min_segs", 99)
    t = toplog.OpLog(port(applied))
    t.enable_tiering(str(tmp_path / f"{name}-t"), **kw)
    t.maybe_spill()
    j = joplog.OpLog(applied)
    j.enable_tiering(str(tmp_path / f"{name}-j"), **kw)
    j.maybe_spill()
    return t, j


def same_files(a, b):
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    assert fa == fb
    for f in fa:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def wire(ops):
    return [tjson.dumps(o) if isinstance(o, top.Operation)
            else jjson.dumps(o) for o in ops]


# -- logical equivalence across tiers ---------------------------------------


def test_tiered_log_matches_untiered_object_contract(tmp_path):
    applied = applied_log(mixed_ops(30))
    flat = toplog.OpLog(port(applied))
    log, jlog = tiered_pair(applied, tmp_path, "eq")
    assert log.spills >= 1 and log.telemetry()["segments"]["cold"] >= 1
    same_files(tmp_path / "eq-t", tmp_path / "eq-j")
    assert len(log) == len(flat) == len(jlog)
    assert wire(log) == wire(applied)
    assert wire([log[5], log[-1]]) == wire([applied[5], applied[-1]])
    assert wire(log[3:17]) == wire(applied[3:17])
    for op in applied:
        if isinstance(op, Add):
            assert log.index_of_add(op.ts) == flat.index_of_add(op.ts) \
                == jlog.index_of_add(op.ts)
    assert log.index_of_add(ts(9, 9)) is None
    a = log.to_packed(max_depth=4)
    b = flat.to_packed(max_depth=4)
    assert wire(tpacked.unpack(a)) == wire(tpacked.unpack(b))
    assert tpacked.verify_hints(a)
    tele, jtele = log.telemetry(), jlog.telemetry()
    for k in ("hot_ops", "cold_ops", "base_ops", "segments", "spills",
              "compactions", "cold_file_bytes"):
        assert tele[k] == jtele[k], k


def test_window_bytes_and_meta_identical_at_every_seam(tmp_path):
    applied = applied_log(mixed_ops(30))
    p = tpacked.pack(port(applied), max_depth=4)
    log, jlog = tiered_pair(applied, tmp_path, "seams", hot_ops=16)
    assert log.telemetry()["segments"]["cold"] >= 3
    view, jview = log.view(max_depth=4), jlog.view(max_depth=4)
    adds = [op.ts for op in applied if isinstance(op, Add)]
    for since in [0] + adds[::2] + adds[-2:]:
        for limit in (0, 1, 3, 5, 8, 16, 1000):
            want = tpacked.packed_since_window(p, since, limit)
            got = view.window(since, limit)
            assert got == want, (since, limit)
            assert got == jview.window(since, limit), (since, limit)
    _, meta = view.window(ts(7, 1), 4)
    assert not meta["found"]
    for since in [0] + adds[::2]:
        assert view.since_bytes(since) == \
            tpacked.packed_since_bytes(p, since) == \
            jview.since_bytes(since), since


def test_operations_since_equivalent_on_tiered_tree(tmp_path):
    ops = mixed_ops(25)
    plain = tengine.init(0, device="cpu")
    tiered = tengine.init(0, device="cpu")
    for op in port(ops):
        plain.apply(op)
        tiered.apply(op)
    tiered.enable_log_tiering(str(tmp_path / "t"), hot_ops=16,
                              gc_min_segs=2)
    tiered._log.maybe_spill()
    assert tiered._log.spills >= 1
    adds = [op.ts for op in plain._log if isinstance(op, top.Add)]
    for boundary in [0] + adds[::3] + adds[-2:]:
        assert tjson.dumps(tiered.operations_since(boundary)) == \
            tjson.dumps(plain.operations_since(boundary)), boundary
    more = port(chain_ops(3, 1200))
    tiered.apply_packed(tpacked.pack(more, max_depth=4))
    plain.apply(top.from_list(more))
    assert tiered.visible_values() == plain.visible_values()
    assert tiered._replicas == plain._replicas


def test_window_chain_stable_across_concurrent_spill_and_gc(tmp_path):
    """A spill, fold or GC landing between the pulls of an in-flight
    window chain never shifts, re-serves or loses a window."""
    applied = applied_log(mixed_ops(30))
    p = tpacked.pack(port(applied), max_depth=4)
    log, _ = tiered_pair(applied, tmp_path, "race", hot_ops=16,
                         gc_min_segs=2)
    view = log.view(max_depth=4)

    def pull_chain(windows_fn):
        since, out = 0, []
        for _ in range(80):
            body, meta = windows_fn(since)
            out.append((body, tuple(sorted(meta.items()))))
            if meta["next_since"] is not None:
                since = meta["next_since"]
            if not meta["more"]:
                return out
        raise AssertionError("chain did not terminate")

    want = pull_chain(lambda s: tpacked.packed_since_window(p, s, 7))
    got, since, step = [], 0, 0
    while True:
        body, meta = view.window(since, 7)
        got.append((body, tuple(sorted(meta.items()))))
        log.extend(port(chain_ops(5, 3, start=1 + 3 * step)))
        log.maybe_spill()
        log.run_gc()
        step += 1
        if meta["next_since"] is not None:
            since = meta["next_since"]
        if not meta["more"]:
            break
    assert got == want
    assert len(log) == len(applied) + 3 * step
    assert log.view(max_depth=4).length == len(log)
    del view
    log.run_gc()
    assert log.telemetry()["gc_deferred"] == 0


def test_gc_gated_by_stability_watermark(tmp_path):
    applied = applied_log(mixed_ops(30))
    log, jlog = tiered_pair(applied, tmp_path, "wm", hot_ops=8,
                            gc_min_segs=2, auto_stable=False)
    tele = log.telemetry()
    assert tele["segments"]["cold"] >= 4 and tele["base_ops"] == 0
    files_before = set(os.listdir(tmp_path / "wm-t"))
    log.run_gc()
    assert log.telemetry()["base_ops"] == 0
    mark = len(log) // 2
    for lg in (log, jlog):
        lg.set_stable_mark(mark)
        lg.run_gc()
    tele = log.telemetry()
    assert 0 < tele["base_ops"] <= mark and tele["compactions"] == 1
    assert tele["base_ops"] == jlog.telemetry()["base_ops"]
    for lg in (log, jlog):
        lg.set_stable_mark(len(lg))
        lg.run_gc()
    tele = log.telemetry()
    assert tele["base_ops"] == len(log) - tele["hot_ops"]
    assert tele["segments"]["cold"] == 0
    assert not (files_before & set(os.listdir(tmp_path / "wm-t")))
    same_files(tmp_path / "wm-t", tmp_path / "wm-j")
    assert wire(log) == wire(applied)


def test_truncate_into_cold_tier(tmp_path):
    applied = applied_log(mixed_ops(20))
    flat = toplog.OpLog(port(applied))
    log, jlog = tiered_pair(applied, tmp_path, "trunc", hot_ops=8)
    assert log.telemetry()["segments"]["cold"] >= 2
    cut = 11
    for lg in (log, flat, jlog):
        lg.truncate(cut)
    assert len(log) == cut
    assert wire(log) == wire(applied[:cut]) == wire(jlog)
    for op in applied:
        if isinstance(op, Add):
            assert log.index_of_add(op.ts) == flat.index_of_add(op.ts)
    extra = Delete((ts(1, 1),))
    log.extend(port([extra]))
    jlog.extend([extra])
    for lg in (log, jlog):
        lg.maybe_spill()
    assert wire(log) == wire(applied[:cut] + [extra]) == wire(jlog)


def _tree_pair(tmp_path, name, hot_ops=256, gc_min_segs=2):
    t = tengine.init(0, device="cpu")
    t.enable_log_tiering(str(tmp_path / f"{name}-t"), hot_ops=hot_ops,
                         gc_min_segs=gc_min_segs)
    j = jengine.init(0)
    j.enable_log_tiering(str(tmp_path / f"{name}-j"), hot_ops=hot_ops,
                         gc_min_segs=gc_min_segs)
    return t, j


def test_restore_checkpoint_plus_tail_bit_identical(tmp_path):
    """A tiered checkpoint + tail restores bit-identically: the same
    files as the reference's, the same log, clocks and visible values,
    every table field equal, and a follow-up bulk merge converges the
    same way — across packages in both directions."""
    big = chain_ops(1, 1500)
    small = chain_ops(2, 30)
    t, j = _tree_pair(tmp_path, "ckpt")
    t.apply_packed(tpacked.pack(port(big), max_depth=4))
    j.apply_packed(jpacked.pack(big, max_depth=4))
    for op in small + [Delete((ts(2, 30),))]:
        t.apply(port([op])[0])
        j.apply(op)
    assert t._log.spills >= 1
    t.checkpoint_tiered(str(tmp_path / "ckpt-t"))
    j.checkpoint_tiered(str(tmp_path / "ckpt-j"))
    same_files(tmp_path / "ckpt-t", tmp_path / "ckpt-j")
    r = tengine.TpuTree.restore_tiered(str(tmp_path / "ckpt-j"),
                                       device="cpu")
    rj = jengine.TpuTree.restore_tiered(str(tmp_path / "ckpt-t"))
    assert wire(r._log) == wire(t._log) == wire(rj._log)
    assert r._replicas == t._replicas == rj._replicas
    assert r.visible_values() == t.visible_values() == rj.visible_values()
    tt, jt = r.table(), rj.table()
    for f in tmerge.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(tt, f)),
                                      np.asarray(getattr(jt, f)), f)
    more = chain_ops(3, 1100)
    r.apply_packed(tpacked.pack(port(more), max_depth=4))
    rj.apply_packed(jpacked.pack(more, max_depth=4))
    assert r.visible_values() == rj.visible_values()
    assert r.dumps_since_bytes(0) == rj.dumps_since_bytes(0)


def test_missing_or_corrupt_segment_is_typed_checkpoint_error(tmp_path):
    t = tengine.init(0, device="cpu")
    t.enable_log_tiering(str(tmp_path / "bad"), hot_ops=64)
    t.apply_packed(tpacked.pack(port(chain_ops(1, 600)), max_depth=4))
    assert t._log.spills >= 1
    t.checkpoint_tiered(str(tmp_path / "bad"))
    seg_files = [f for f in os.listdir(tmp_path / "bad")
                 if f.startswith("seg-")]
    victim = tmp_path / "bad" / seg_files[0]
    blob = victim.read_bytes()
    victim.write_bytes(blob[: len(blob) // 2])
    with pytest.raises(CheckpointError):
        tengine.TpuTree.restore_tiered(str(tmp_path / "bad"), device="cpu")
    victim.unlink()
    with pytest.raises(CheckpointError):
        tengine.TpuTree.restore_tiered(str(tmp_path / "bad"), device="cpu")
    live = toplog.OpLog(port(chain_ops(1, 60)))
    live.enable_tiering(str(tmp_path / "live"), hot_ops=8,
                        cache_segments=1)
    live.maybe_spill()
    for f in os.listdir(tmp_path / "live"):
        os.remove(tmp_path / "live" / f)
    with pytest.raises(CheckpointError):
        live.materialize(0, 10)
    with pytest.raises(CheckpointError):
        live.view(4).window(ts(1, 1), 4)


@pytest.mark.parametrize("damage", ["garbage", "gap", "length", "missing"])
def test_corrupt_manifest_is_typed(tmp_path, damage):
    t = tengine.init(0, device="cpu")
    d = tmp_path / "m"
    t.enable_log_tiering(str(d), hot_ops=64)
    t.apply_packed(tpacked.pack(port(chain_ops(1, 300)), max_depth=4))
    t.checkpoint_tiered(str(d))
    mpath = d / "manifest.json"
    m = json.loads(mpath.read_text())
    if damage == "garbage":
        mpath.write_text("{not json")
    elif damage == "gap":
        m["segments"][0]["start"] += 1
        mpath.write_text(json.dumps(m))
    elif damage == "length":
        m["length"] += 5
        mpath.write_text(json.dumps(m))
    else:
        mpath.unlink()
    with pytest.raises(CheckpointError):
        tengine.TpuTree.restore_tiered(str(d), device="cpu")
    with pytest.raises(JCheckpointError):
        jengine.TpuTree.restore_tiered(str(d))


def test_base_chunks_window_identity_at_chunk_seams(tmp_path):
    applied = applied_log(mixed_ops(30))
    p = tpacked.pack(port(applied), max_depth=4)
    log, jlog = tiered_pair(applied, tmp_path, "bc", hot_ops=8,
                            gc_min_segs=1, base_chunk_ops=16)
    for lg in (log, jlog):
        lg.set_stable_mark(len(lg))
        lg.run_gc()
    tele = log.telemetry()
    assert tele["segments"]["base"] >= 3
    assert tele["base_ops"] == len(log) - tele["hot_ops"]
    same_files(tmp_path / "bc-t", tmp_path / "bc-j")
    view = log.view(max_depth=4)
    adds = [op.ts for op in applied if isinstance(op, Add)]
    for since in [0] + adds + adds[-2:]:
        for limit in (0, 1, 3, 8, 16, 17, 1000):
            assert view.window(since, limit) == \
                tpacked.packed_since_window(p, since, limit), \
                (since, limit)


def test_fold_rewrites_only_trailing_partial_chunk(tmp_path):
    applied = applied_log(mixed_ops(40))
    log, jlog = tiered_pair(applied, tmp_path, "wa", hot_ops=8,
                            gc_min_segs=1, base_chunk_ops=16)
    for lg in (log, jlog):
        lg.set_stable_mark(len(lg))
        lg.run_gc()
    full_before = {cs.path for cs in log._bases if cs.length == 16}
    assert full_before
    for lg, ops in ((log, port(chain_ops(8, 60))), (jlog, chain_ops(8, 60))):
        lg.extend(ops)
        lg.maybe_spill()
        lg.set_stable_mark(len(lg))
        lg.run_gc()
    assert full_before <= {cs.path for cs in log._bases}
    assert wire(log) == wire(applied + chain_ops(8, 60))
    same_files(tmp_path / "wa-t", tmp_path / "wa-j")


def test_hot_bytes_budget_spills_by_bytes(tmp_path, monkeypatch):
    ops = [Add(ts(1, c), ((ts(1, c - 1) if c > 1 else 0),), "x" * 2000)
           for c in range(1, 201)]
    budget = 100_000
    teles = []
    for mod, o in ((toplog, port(ops)), (joplog, ops)):
        log = mod.OpLog()
        p = (tpacked if mod is toplog else jpacked).pack(o, max_depth=4)
        if mod is toplog:
            # the port prices its timestamp index at its arrays' bytes;
            # the reference's dict is held to the same ruler
            monkeypatch.setattr(joplog, "_DICT_ENTRY_BYTES",
                                p.ts_index.nbytes // len(p.ts_index))
        log.extend_packed(p)
        log.enable_tiering(str(tmp_path / mod.__name__), hot_ops=100_000,
                           hot_bytes=budget, gc_min_segs=99)
        assert log.maybe_spill()
        teles.append(log.telemetry())
    tele = teles[0]
    assert tele["spills"] >= 1 and tele["hot_ops"] < 200
    assert tele["hot_bytes"] <= 2 * budget
    assert (tele["spills"], tele["hot_ops"]) == \
        (teles[1]["spills"], teles[1]["hot_ops"])


def test_shared_segment_cache_counts_per_log(tmp_path):
    """One engine-wide LRU shared by several logs: each log reports its
    own loads, and the shared cap evicts."""
    cache = toplog.make_seg_cache(cache_mb=0, cap=1)
    logs = []
    for k in range(2):
        lg = toplog.OpLog(port(chain_ops(k + 1, 64)))
        lg.enable_tiering(str(tmp_path / f"c{k}"), hot_ops=8,
                          cache=cache, gc_min_segs=99)
        lg.maybe_spill()
        logs.append(lg)
    for lg in logs:
        lg.materialize(0, 20)
    t0, t1 = logs[0].telemetry(), logs[1].telemetry()
    assert t0["segment_loads"] >= 1 and t1["segment_loads"] >= 1
    assert cache.evictions >= 1


# -- scrub, quarantine and repair ---------------------------------------------


def _flip_byte(path):
    """One bit-rot event inside the data of the largest zip member (a
    flip in a local header is benign and legitimately not flagged)."""
    import struct
    with zipfile.ZipFile(path) as z:
        info = max(z.infolist(), key=lambda i: i.compress_size)
    with open(path, "r+b") as f:
        f.seek(info.header_offset + 26)
        fn_len, extra_len = struct.unpack("<HH", f.read(4))
        f.seek(info.header_offset + 30 + fn_len + extra_len
               + info.compress_size // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


def test_verify_packed_npz_catches_flips(tmp_path):
    p = tpacked.pack(port([Add(ts(1, c), (0,), c) for c in range(1, 9)]))
    path = str(tmp_path / "seg.npz")
    tpacked.write_packed_npz(path, p, {"num_ops": p.num_ops})
    assert tpacked.verify_packed_npz(path) is None
    assert tpacked.verify_packed_npz(path, expect_ops=p.num_ops) is None
    assert tpacked.verify_packed_npz(path, expect_ops=99)
    _flip_byte(path)
    assert tpacked.verify_packed_npz(path) is not None
    assert jpacked.verify_packed_npz(path) is not None
    assert tpacked.verify_packed_npz(str(tmp_path / "no.npz")) is not None


def _durable_tree(d, n=600):
    t = tengine.init(3, device="cpu")
    t.enable_log_tiering(str(d), hot_ops=64, gc_min_segs=2, durable=True,
                         base_chunk_ops=128)
    t._log.set_durable_hooks(t.manifest_meta, None)
    for k in range(0, n, 100):
        t.apply_packed(tpacked.pack(port(chain_ops(
            3, 100, start=k + 1)), max_depth=4))
    assert t.write_matz()
    return t


def test_scrub_quarantines_and_the_manifest_carries_it(tmp_path):
    """A clean scrub finds nothing; flipping a cold segment, a base chunk
    and the matz artifact quarantines the two tier files (a window over
    them is a typed refusal), drops the artifact, and the quarantine
    rides the manifest into a restore, where values still serve."""
    d = tmp_path / "srv"
    t = _durable_tree(d)
    log = t._log
    clean = log.scrub()
    assert clean["corrupt"] == 0 and clean["checked"] > 0
    segs = [s.path for s in log._cold]
    bases = [s.path for s in log._bases]
    matz = d / log.matz_entry["file"]
    assert segs and bases
    want = t.visible_values()
    _flip_byte(segs[-1])
    _flip_byte(bases[0])
    _flip_byte(str(matz))
    rep = log.scrub()
    assert rep["corrupt"] == 2 and rep["matz_dropped"] == 1
    tele = log.telemetry()
    assert tele["quarantined"] == 2 and tele["quarantines"] == 2
    assert log.matz_entry is None
    with pytest.raises(CheckpointError, match="quarantined"):
        log.view().window(0, 50)
    assert log.scrub()["corrupt"] == 0      # idempotent
    m = json.loads((d / "manifest.json").read_text())
    flagged = [e for e in m["base_chunks"] + m["segments"]
               if e.get("quarantined")]
    assert len(flagged) == 2
    r = tengine.TpuTree.restore_tiered(str(d), device="cpu")
    assert r._log.telemetry()["quarantined"] == 2
    with pytest.raises(CheckpointError, match="quarantined"):
        r._log.view().window(0, 50)
    rj = jengine.TpuTree.restore_tiered(str(d))
    assert rj._log.telemetry()["quarantined"] == 2
    assert want == [f"v3.{c}" for c in range(1, 601)]


def test_scrub_repair_round_trip_from_a_healthy_replica(tmp_path):
    """A quarantined segment heals with the rows a healthy replica
    serves for its range: the refetched rows are cross-checked against
    the resident add index, the file is resealed, the manifest rewritten
    and every window is byte-identical to the healthy replica's again.
    Rows that disagree with the index are refused."""
    d = tmp_path / "sick"
    sick = _durable_tree(d)
    healthy = _durable_tree(tmp_path / "ok")
    log = sick._log
    victim = log._cold[0]
    _flip_byte(victim.path)
    assert log.scrub()["corrupt"] == 1
    (seg,) = log.quarantined_segments()
    spec = log.repair_spec(seg)
    assert spec["stop"] - spec["start"] == seg.length
    rows = healthy.log_view().slice_packed(spec["start"], spec["stop"])
    wrong = healthy.log_view().slice_packed(spec["start"] + 1,
                                            spec["stop"] + 1)
    assert not log.repair_segment(seg, wrong)
    assert log.repair_segment(seg, rows)
    assert log.telemetry()["quarantined"] == 0 and log.repairs == 1
    hv, sv = healthy.log_view(), sick.log_view()
    since = 0
    for _ in range(100):
        a, b = sv.window(since, 50), hv.window(since, 50)
        assert a == b
        if not a[1]["more"]:
            break
        since = a[1]["next_since"]
    r = tengine.TpuTree.restore_tiered(str(d), device="cpu")
    assert r._log.telemetry()["quarantined"] == 0
    assert r.dumps_since_bytes(0) == healthy.dumps_since_bytes(0)


def test_wire_sidecar_plans_equal_buffered_windows(tmp_path):
    """Cold segments' wire sidecars (the zero-copy egress plan): a
    window landing on cold tiers first reports its missing sidecars;
    once built, the plan's assembled bytes and meta equal the buffered
    window's, its ETag is the sha1 of those bytes, and the sidecar files
    are byte-identical to the reference's."""
    import hashlib
    applied = applied_log(mixed_ops(30))
    log, jlog = tiered_pair(applied, tmp_path, "wire", hot_ops=16)
    adds = [op.ts for op in applied if isinstance(op, Add)]
    view, jview = log.view(max_depth=4), jlog.view(max_depth=4)
    plan, missing = view.window_plan(adds[1], 12)
    assert plan is None and missing
    for seg in log._cold:
        assert toplog.ensure_wire_sidecar(seg)
    for seg in jlog._cold:
        assert joplog.ensure_wire_sidecar(seg)
    planned = 0
    for since in [0] + adds[::3]:
        for limit in (3, 12, 16):
            plan, _ = view.window_plan(since, limit)
            if plan is None:
                continue
            chunks, total, meta = plan
            body = b"".join(
                c[1] if c[0] == "b" else
                open(c[1], "rb").read()[c[2]:c[2] + c[3]] for c in chunks)
            want = view.window(since, limit)
            assert (body, meta) == want, (since, limit)
            assert len(body) == total
            assert toplog.plan_etag(chunks) == \
                f'"{hashlib.sha1(body).hexdigest()}"'
            assert jview.window_plan(since, limit)[0][1:] == plan[1:]
            planned += 1
    assert planned >= 5
    wires = sorted(f for f in os.listdir(tmp_path / "wire-t")
                   if ".wire" in f)
    assert wires
    for f in wires:
        assert (tmp_path / "wire-t" / f).read_bytes() == \
            (tmp_path / "wire-j" / f).read_bytes(), f
