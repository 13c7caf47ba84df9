"""The port's write-ahead log and durable recovery against the reference
package's, on the CPU.

The same commits go through ``crdt_graph_tpu.wal`` / ``engine`` and
``crdt_graph_tpu_torch.wal`` / ``engine`` (``device="cpu"``).  The WAL
record bytes, the cold segments, ``manifest.json`` and the matz artifact
must be byte-identical; the record taxonomy (torn tail tolerated and
counted, mid-log damage a typed ``WalError``), the repair of a failed
append and idempotent duplicate replay must hold; the crash sites fire
in-process; and a durable directory written by either package recovers
in the other with every ``NodeTable`` field equal.

The zip members' timestamps are the only bytes of an npz blob that
depend on the wall clock: every test here freezes the zip clock so whole
files compare.
"""
import os
import time
import types
import warnings
import zipfile

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

torch.set_num_threads(1)

from crdt_graph_tpu import engine as jengine  # noqa: E402
from crdt_graph_tpu import wal as jwal  # noqa: E402
from crdt_graph_tpu.codec import json_codec as jjson  # noqa: E402
from crdt_graph_tpu.codec import packed as jpacked  # noqa: E402
from crdt_graph_tpu.core.operation import Add, Batch, Delete  # noqa: E402

from crdt_graph_tpu_torch import engine as tengine  # noqa: E402
from crdt_graph_tpu_torch import wal as twal  # noqa: E402
from crdt_graph_tpu_torch.codec import json_codec as tjson  # noqa: E402
from crdt_graph_tpu_torch.codec import packed as tpacked  # noqa: E402
from crdt_graph_tpu_torch.core import operation as top  # noqa: E402
from crdt_graph_tpu_torch.ops import merge as tmerge  # noqa: E402

OFF = 2**32

# ``egress``: the module of each package that serves the anti-entropy
# window off one packing
J = types.SimpleNamespace(name="jax", engine=jengine, wal=jwal,
                          packed=jpacked, egress=jengine, dev={})
T = types.SimpleNamespace(name="torch", engine=tengine, wal=twal,
                          packed=tpacked, egress=tpacked,
                          dev={"device": "cpu"})


@pytest.fixture(autouse=True)
def frozen_zip_clock(monkeypatch):
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: 1_700_000_000.0, localtime=time.localtime))
    monkeypatch.delenv("GRAFT_CRASH_POINT", raising=False)
    monkeypatch.delenv("GRAFT_CRASH_EXIT", raising=False)


def ts(r, c):
    return r * OFF + c


def chain_ops(r, n, start=1):
    out = []
    prev = ts(r, start - 1) if start > 1 else 0
    for c in range(start, start + n):
        out.append(Add(ts(r, c), (prev,), f"v{r}.{c}"))
        prev = ts(r, c)
    return out


def ops_for(pkg, ops):
    """Reference op objects → ``pkg``'s, through the wire JSON."""
    if pkg is J:
        return list(ops)
    return [tjson.loads(jjson.dumps(o)) for o in ops]


def pack(pkg, ops):
    return pkg.packed.pack(ops_for(pkg, ops), max_depth=4)


def dir_bytes(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))
            if not f.endswith(".tmp")}


def assert_same_dirs(a, b):
    ba, bb = dir_bytes(a), dir_bytes(b)
    assert sorted(ba) == sorted(bb)
    for f in ba:
        assert ba[f] == bb[f], f


def assert_tables_equal(t, j):
    tt, jt = t.table(), j.table()
    for f in tmerge.FIELDS:
        want = np.asarray(getattr(jt, f))
        got = np.asarray(getattr(tt, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def assert_same_state(t, j):
    """A port replica and a reference replica hold the same state: log,
    clocks, visible values, wire suffixes and every table field."""
    assert t.log_length == j.log_length
    assert t.visible_values() == j.visible_values()
    assert t._replicas == j._replicas
    assert (t.timestamp, tuple(t.cursor)) == (j.timestamp, tuple(j.cursor))
    adds = [op.ts for op in j._log if isinstance(op, Add)]
    for since in [0] + adds[::max(1, len(adds) // 5)] + adds[-1:]:
        assert t.dumps_since_bytes(since) == j.dumps_since_bytes(since)
    assert_tables_equal(t, j)


def windows_match_untiered(pkg, tree, sinces=(0,), limits=(0, 7)):
    """The recovered log's window answers vs ``packed_since_window``
    over its own full packing — the tiered/untiered byte contract."""
    view = tree.log_view()
    full = view.to_packed()
    for since in sinces:
        for limit in limits:
            if limit:
                assert view.window(since, limit) == \
                    pkg.egress.packed_since_window(full, since, limit)
            else:
                assert view.since_bytes(since) == \
                    pkg.egress.packed_since_bytes(full, since)


# -- raw WAL format + corruption taxonomy ----------------------------------


def raw_wal(pkg, path, n_records=3, deletes=False):
    w = pkg.wal.Wal(str(path))
    pos = 0
    for k in range(n_records):
        ops = chain_ops(1, 5, start=1 + 5 * k)
        if deletes:
            ops.append(Delete((ts(1, 2 + 5 * k),)))
        pos += len(ops)
        w.append(pack(pkg, ops), pos)
    w.sync()
    w.close()
    return w


@pytest.mark.parametrize("deletes", [False, True])
def test_wal_record_bytes_identical_to_reference(tmp_path, deletes):
    wt = raw_wal(T, tmp_path / "t.log", 4, deletes)
    wj = raw_wal(J, tmp_path / "j.log", 4, deletes)
    assert open(wt.path, "rb").read() == open(wj.path, "rb").read()
    assert twal.encode_record(pack(T, chain_ops(2, 3)), 9) == \
        jwal.encode_record(pack(J, chain_ops(2, 3)), 9)
    assert twal.encode_shared_record("doc", pack(T, chain_ops(2, 3)), 9) \
        == jwal.encode_shared_record("doc", pack(J, chain_ops(2, 3)), 9)
    # truncation rewrites the same bytes too
    dropped = 2 if not deletes else 1      # records of 5 or 6 ops
    assert twal.Wal(wt.path).truncate_below(10) == \
        jwal.Wal(wj.path).truncate_below(10) == dropped
    assert open(wt.path, "rb").read() == open(wj.path, "rb").read()
    assert twal.Wal(wt.path).verify() == jwal.Wal(wj.path).verify()


def test_wal_scan_roundtrip_and_truncate_below(tmp_path):
    w = raw_wal(T, tmp_path / "wal.log", n_records=3)
    records, torn, good = twal.scan(w.path)
    assert [r[1] for r in records] == [5, 10, 15] and torn == 0
    _, p = twal._decode_payload(records[1][2])
    assert tpacked.unpack_rows(p, 0, p.num_ops) == \
        ops_for(T, chain_ops(1, 5, start=6))
    w2 = twal.Wal(w.path)
    assert w2.truncate_below(10) == 2
    records, torn, _ = twal.scan(w.path)
    assert [r[1] for r in records] == [15] and torn == 0
    assert w2.truncate_below(10) == 0
    w2.close()


def test_wal_torn_final_record_tolerated_and_counted(tmp_path):
    w = raw_wal(T, tmp_path / "wal.log", n_records=2)
    data = open(w.path, "rb").read()
    for cut in (7, 1, len(data) - twal.scan(w.path)[0][1][0] - 3):
        torn_path = str(tmp_path / f"torn{cut}.log")
        with open(torn_path, "wb") as f:
            f.write(data[:-cut])
        records, torn, good = twal.scan(torn_path)
        assert torn == 1 and len(records) == 1, cut
        assert (records, torn, good) == jwal.scan(torn_path)
        assert twal.Wal(torn_path).verify() == \
            jwal.Wal(torn_path).verify()
    flipped = bytearray(data)
    flipped[-3] ^= 0xFF
    flip_path = str(tmp_path / "flip-last.log")
    with open(flip_path, "wb") as f:
        f.write(bytes(flipped))
    records, torn, _ = twal.scan(flip_path)
    assert torn == 1 and len(records) == 1
    # replay drops and counts the torn tail, then truncates it away
    t = tengine.init(0, device="cpu")
    stats = twal.Wal(flip_path).replay_into(t)
    assert stats["torn_dropped"] == 1 and t.log_length == 5
    assert twal.scan(flip_path)[1] == 0


def test_wal_midlog_corruption_raises_typed(tmp_path):
    w = raw_wal(T, tmp_path / "wal.log", n_records=3)
    data = bytearray(open(w.path, "rb").read())
    records, _, _ = twal.scan(w.path)
    data[records[0][0] + 12] ^= 0xFF
    with open(w.path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(twal.WalError):
        twal.scan(w.path)
    with pytest.raises(jwal.WalError):
        jwal.scan(w.path)
    v = twal.Wal(w.path).verify()
    assert v["mid_log"] == 1 and v["records"] == 0
    t = tengine.init(0, device="cpu")
    with pytest.raises(twal.WalError):
        twal.Wal(w.path).replay_into(t)
    assert t.log_length == 0
    with open(w.path, "wb") as f:
        f.write(b"NOTAWAL!" + bytes(16))
    with pytest.raises(twal.WalError):
        twal.scan(w.path)


def test_wal_duplicate_replay_idempotent_after_crash_mid_truncate(
        tmp_path):
    """A crash between a spill's manifest write and the WAL truncate
    leaves records the tiers already cover: replaying the same file
    again must absorb through the apply dedup."""
    w = raw_wal(T, tmp_path / "wal.log", n_records=3)
    ref = jengine.init(0)
    ref.apply(Batch(tuple(chain_ops(1, 15))))
    t = tengine.init(0, device="cpu")
    stats = twal.Wal(w.path).replay_into(t)
    assert stats["ops"] == 15 and t.log_length == 15
    again = twal.Wal(w.path).replay_into(t)
    assert again["applied"] == 0 and again["skipped"] == 3
    # a straddling record re-applies whole and the overlap absorbs
    part = tengine.init(0, device="cpu")
    part.apply(top.from_list(ops_for(T, chain_ops(1, 7))))
    st = twal.Wal(w.path).replay_into(part)
    assert (st["skipped"], st["records"], st["applied"]) == (1, 2, 8)
    assert part.visible_values() == ref.visible_values()
    assert t.log_length == 15
    assert t.visible_values() == ref.visible_values()
    windows_match_untiered(T, t, sinces=(0, ts(1, 1), ts(1, 9)))


def test_wal_records_deletes_and_replays_them(tmp_path):
    ops = chain_ops(1, 8) + [Delete((ts(1, c),)) for c in (2, 5, 8)]
    ref = jengine.init(0)
    ref.apply(Batch(tuple(ops)))
    w = twal.Wal(str(tmp_path / "wal.log"))
    w.append(pack(T, ops), len(ops))
    w.sync()
    w.close()
    t = tengine.init(0, device="cpu")
    twal.Wal(w.path).replay_into(t)
    assert t.visible_values() == ref.visible_values()
    assert t.log_length == ref.log_length
    windows_match_untiered(T, t, sinces=(0, ts(1, 3)), limits=(0, 4))


def test_wal_failed_append_repairs_to_record_boundary(tmp_path):
    w = raw_wal(T, tmp_path / "wal.log", n_records=2)
    good = os.path.getsize(w.path)
    with open(w.path, "ab") as f:
        f.write(b"\x99" * 11)
    w2 = twal.Wal(w.path)
    w2._size = good
    w2._repair_locked(good)
    assert w2.repairs == 1
    w2.append(pack(T, chain_ops(1, 3, start=11)), 13)
    w2.sync()
    w2.close()
    records, torn, _ = twal.scan(w.path)
    assert torn == 0 and len(records) == 3
    _, p = twal._decode_payload(records[-1][2])
    assert tpacked.unpack_rows(p, 0, p.num_ops) == \
        ops_for(T, chain_ops(1, 3, start=11))


def test_failed_sync_drops_the_unsynced_tail(tmp_path, monkeypatch):
    """A failed fsync truncates the unsynced records away (their commits
    are being rolled back), leaving a clean prefix of what was acked."""
    w = raw_wal(T, tmp_path / "wal.log", n_records=2)
    w2 = twal.Wal(w.path)
    w2.append(pack(T, chain_ops(1, 3, start=11)), 13)

    real, calls = os.fsync, []

    def boom(fd):                   # the first fsync fails, then recovers
        calls.append(fd)
        if len(calls) == 1:
            raise OSError(5, "EIO")
        real(fd)
    monkeypatch.setattr(twal.os, "fsync", boom)
    with pytest.raises(OSError):
        w2.sync()
    monkeypatch.undo()
    assert [r[1] for r in twal.scan(w.path)[0]] == [5, 10]
    assert w2.errors == 1 and w2.repairs == 1


def test_shared_wal_per_doc_views_replay(tmp_path):
    """The shared stream carries several documents' records; each
    document's view replays only its own, and marks compact."""
    sw = twal.SharedWal(str(tmp_path / "wal-shared.log"))
    jw = jwal.SharedWal(str(tmp_path / "j-shared.log"))
    for doc, ops, end in (("a", chain_ops(1, 5), 5),
                          ("b", chain_ops(2, 5), 5),
                          ("a", chain_ops(1, 5, start=6), 10)):
        sw.append(doc, pack(T, ops), end)
        jw.append(doc, pack(J, ops), end)
    sw.sync()
    jw.sync()
    assert open(sw.path, "rb").read() == open(jw.path, "rb").read()
    recs = twal.SharedWal(sw.path).recover_records()
    assert sorted(recs) == ["a", "b"] and len(recs["a"]) == 2
    t = tengine.init(0, device="cpu")
    view = twal.DocWalView(sw, "a", recs["a"])
    st = view.replay_into(t)
    assert st["ops"] == 10 and t.log_length == 10
    assert t.visible_values() == [f"v1.{c}" for c in range(1, 11)]
    sw.mark_durable("a", 10)
    sw.mark_durable("b", 5)
    assert sw.compact() == 3
    assert twal.scan_shared(sw.path)[0] == []


def test_bump_epoch_and_sync_knobs(tmp_path, monkeypatch):
    assert twal.bump_epoch(str(tmp_path)) == 1
    assert jwal.bump_epoch(str(tmp_path)) == 2
    assert twal.bump_epoch(str(tmp_path)) == 3
    monkeypatch.setenv("GRAFT_WAL_SYNC", "nope")
    assert twal.sync_mode_from_env() == "batch"
    monkeypatch.setenv("GRAFT_WAL_SYNC", "commit")
    assert twal.sync_mode_from_env() == "commit"
    assert twal.CRASH_SITES == jwal.CRASH_SITES


# -- durable replicas: commits, crashes, recovery ----------------------------


def commits_of(n_small=8, big=None):
    """Small host-path commits of 5 ops each (one with deletes), with an
    optional bulk commit of ``big`` ops in the middle."""
    out = []
    c = 1
    for k in range(n_small):
        ops = chain_ops(1, 5, start=c)
        c += 5
        if k == 3:
            ops.append(Delete((ts(1, c - 3),)))
        out.append(ops)
        if big and k == n_small // 2:
            out.append(chain_ops(2, big))
    return out


def durable_run(pkg, d, commits, monkeypatch, crash=None, matz_after=None):
    """Drive ``commits`` through a durable tiered replica the way a
    durable server does: apply, append the applied rows to the WAL,
    fsync, and truncate the WAL below the tiered extent once a manifest
    advanced it.  ``crash=(i, site)`` arms ``GRAFT_CRASH_POINT`` for
    commit ``i``; ``matz_after=i`` writes the matz artifact after commit
    ``i``.  Returns the number of acknowledged commits."""
    os.makedirs(d, exist_ok=True)
    t = pkg.engine.init(0, **pkg.dev)
    t.enable_log_tiering(str(d), hot_ops=8, gc_min_segs=2, durable=True,
                         base_chunk_ops=16)
    advanced = []
    t._log.set_durable_hooks(t.manifest_meta, advanced.append)
    w = pkg.wal.Wal(str(d / "wal.log"))
    acked = 0
    try:
        for i, ops in enumerate(commits):
            if crash is not None and crash[0] == i:
                monkeypatch.setenv("GRAFT_CRASH_POINT", crash[1])
            n0 = t.log_length
            t.apply_packed(pack(pkg, ops))
            if t.log_length > n0:
                w.append(t.log_view().slice_packed(n0, t.log_length),
                         t.log_length)
            w.sync()
            if advanced:
                w.truncate_below(t._log.tiered_extent)
                advanced.clear()
            acked += 1
            if matz_after == i:
                assert t.write_matz()
    except pkg.wal.CrashPoint:
        pass
    finally:
        monkeypatch.delenv("GRAFT_CRASH_POINT", raising=False)
        w.close()
    return acked


def recover(pkg, d, **kw):
    """Tiers from the manifest (when one landed), then the WAL tail."""
    if (d / "manifest.json").exists():
        r = pkg.engine.TpuTree.restore_tiered(str(d), **pkg.dev, **kw)
    else:
        r = pkg.engine.init(0, **pkg.dev)
    stats = pkg.wal.Wal(str(d / "wal.log")).replay_into(r)
    return r, stats


def acked_ops(commits, n):
    return [op for ops in commits[:n] for op in ops]


@pytest.mark.parametrize("site", ["mid-spill", "mid-fold",
                                  "mid-manifest-write", "mid-matz-write"])
def test_crash_site_recovers_acked_prefix_in_both_packages(
        tmp_path, monkeypatch, site):
    """Each crash site fires in-process in both packages at the same
    commit.  The crashed directories are byte-identical; each recovers
    in the other package too; every recovery holds the acknowledged
    prefix, equal field for field across packages."""
    commits = commits_of(10)
    crash_at = 6
    if site == "mid-matz-write":
        crash = None
        matz_after = crash_at
    else:
        crash = (crash_at, site)
        matz_after = None
    acked = {}
    for pkg in (T, J):
        d = tmp_path / pkg.name
        if matz_after is not None:
            monkeypatch.setenv("GRAFT_CRASH_POINT", site)
        acked[pkg.name] = durable_run(pkg, d, commits, monkeypatch,
                                      crash=crash, matz_after=matz_after)
        monkeypatch.delenv("GRAFT_CRASH_POINT", raising=False)
    assert acked["torch"] == acked["jax"] <= crash_at + 1
    assert_same_dirs(tmp_path / "torch", tmp_path / "jax")
    want = acked_ops(commits, acked["torch"])
    for writer in ("torch", "jax"):
        for pkg in (T, J):
            src = tmp_path / writer
            d = tmp_path / f"{writer}-by-{pkg.name}"
            d.mkdir()
            for f, b in dir_bytes(src).items():
                (d / f).write_bytes(b)
        rt, st_t = recover(T, tmp_path / f"{writer}-by-torch")
        rj, st_j = recover(J, tmp_path / f"{writer}-by-jax")
        assert st_t == st_j
        got = list(rt._log)
        assert [tjson.dumps(o) for o in got[:len(want)]] == \
            [jjson.dumps(o) for o in want]
        assert_same_state(rt, rj)


def test_uncrashed_recovery_equals_the_live_replica(tmp_path, monkeypatch):
    """No crash: the recovered replica equals the live one (the WAL
    holds exactly the hot tail past the tiers), with a bulk commit in
    the middle that merges through the batched path."""
    commits = commits_of(6, big=1100)
    for pkg in (T, J):
        durable_run(pkg, tmp_path / pkg.name, commits, monkeypatch)
    assert_same_dirs(tmp_path / "torch", tmp_path / "jax")
    live = jengine.init(0)
    for ops in commits:
        live.apply_packed(pack(J, ops))
    rt, st = recover(T, tmp_path / "torch")
    assert st["records"] >= 1 and st["skipped"] >= 0
    assert_same_state(rt, live)
    windows_match_untiered(T, rt, sinces=(0, ts(1, 3), ts(2, 700)),
                           limits=(0, 5, 16))


# -- the persisted materialization -------------------------------------------


def fresh_tiered(pkg, d, n=900):
    t = pkg.engine.init(0, **pkg.dev)
    t.enable_log_tiering(str(d), hot_ops=64, gc_min_segs=2)
    t.apply_packed(pack(pkg, chain_ops(1, n)))
    return t


def test_matz_artifact_bytes_and_corruption_taxonomy(tmp_path):
    """The artifact, its manifest entry and the checkpoint files are
    byte-identical to the reference's; a healthy artifact serves the
    first read with zero fallbacks; a stale one dup-absorbs through tail
    replay; a flipped, truncated or missing one falls back to the full
    merge with a typed ``MatzWarning`` — never wrong data."""
    ref = jengine.init(0)
    ref.apply(Batch(tuple(chain_ops(1, 900))))
    want = ref.visible_values()

    for pkg in (T, J):
        t = fresh_tiered(pkg, tmp_path / f"ok-{pkg.name}")
        t.checkpoint_tiered(str(tmp_path / f"ok-{pkg.name}"))
    assert_same_dirs(tmp_path / "ok-torch", tmp_path / "ok-jax")
    r = tengine.TpuTree.restore_tiered(str(tmp_path / "ok-jax"),
                                       device="cpu")
    assert r.visible_values() == want
    assert r.matz_stats == {"writes": 0, "loads": 1, "fallbacks": 0,
                            "tail_replayed": 0}
    rj = jengine.TpuTree.restore_tiered(str(tmp_path / "ok-torch"))
    assert_same_state(r, rj)

    t = fresh_tiered(T, tmp_path / "stale", n=700)
    assert t.write_matz()
    t.apply(top.from_list(ops_for(T, chain_ops(1, 200, start=701))))
    t.checkpoint_tiered(str(tmp_path / "stale"), write_matz=False)
    r = tengine.TpuTree.restore_tiered(str(tmp_path / "stale"),
                                       device="cpu")
    assert r.visible_values() == want
    assert r.matz_stats["loads"] == 1
    assert r.matz_stats["tail_replayed"] == 200

    for mode in ("flip", "trunc", "missing"):
        d = tmp_path / f"bad-{mode}"
        t = fresh_tiered(T, d)
        t.checkpoint_tiered(str(d))
        victim = next(d.glob("matz-*.npz"))
        blob = victim.read_bytes()
        if mode == "flip":
            flipped = bytearray(blob)
            flipped[len(flipped) // 2] ^= 0xFF
            victim.write_bytes(bytes(flipped))
        elif mode == "trunc":
            victim.write_bytes(blob[: len(blob) // 3])
        else:
            victim.unlink()
        r = tengine.TpuTree.restore_tiered(str(d), device="cpu")
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            vals = r.visible_values()
        assert any(issubclass(x.category, tengine.MatzWarning)
                   for x in w), mode
        assert r.matz_stats["fallbacks"] == 1, mode
        assert vals == want, mode


def test_background_matz_export_matches_reference(tmp_path):
    """The two-half export (snapshot the mirror, then serialize and
    publish it) writes the same artifact and manifest as the reference,
    and a restore's first read comes off it."""
    for pkg in (T, J):
        d = tmp_path / f"bg-{pkg.name}"
        t = fresh_tiered(pkg, d, n=500)
        t.enable_log_tiering(str(d), hot_ops=64, gc_min_segs=2,
                             durable=True)
        t._log.set_durable_hooks(t.manifest_meta, None)
        t.visible_values()
        snap = t.matz_snapshot()
        assert snap is not None and snap["len"] == 500
        assert t.export_matz(snap)
    assert_same_dirs(tmp_path / "bg-torch", tmp_path / "bg-jax")
    r = tengine.TpuTree.restore_tiered(str(tmp_path / "bg-jax"),
                                       device="cpu")
    assert r.visible_values() == [f"v1.{c}" for c in range(1, 501)]
    assert r.matz_stats["loads"] == 1 and r.matz_stats["fallbacks"] == 0


def test_matz_disabled_by_switch(tmp_path, monkeypatch):
    monkeypatch.setenv("GRAFT_MATZ", "0")
    assert not tengine.matz_enabled()
    t = fresh_tiered(T, tmp_path / "off", n=300)
    assert not t.write_matz()
    t.checkpoint_tiered(str(tmp_path / "off"))
    assert not list((tmp_path / "off").glob("matz-*.npz"))


def test_restore_tiered_preserves_last_operation(tmp_path):
    for pkg in (T, J):
        t = pkg.engine.init(0, **pkg.dev)
        t.apply(top.from_list(ops_for(pkg, chain_ops(1, 30)))
                if pkg is T else Batch(tuple(chain_ops(1, 30))))
        t.checkpoint_tiered(str(tmp_path / f"ck-{pkg.name}"))
        t2 = pkg.engine.init(0, **pkg.dev)
        t2.apply(top.from_list(ops_for(pkg, chain_ops(2, 6)))
                 if pkg is T else Batch(tuple(chain_ops(2, 6))))
        t2.apply(ops_for(pkg, [Add(ts(2, 7), (ts(2, 6),), "bare")])[0])
        t2.checkpoint_tiered(str(tmp_path / f"ck2-{pkg.name}"))
    assert_same_dirs(tmp_path / "ck-torch", tmp_path / "ck-jax")
    assert_same_dirs(tmp_path / "ck2-torch", tmp_path / "ck2-jax")
    r = tengine.TpuTree.restore_tiered(str(tmp_path / "ck-jax"),
                                       device="cpu")
    assert len(r.last_operation.ops) == 30
    assert tjson.dumps(r.last_operation) == \
        jjson.dumps(Batch(tuple(chain_ops(1, 30))))
    r2 = tengine.TpuTree.restore_tiered(str(tmp_path / "ck2-jax"),
                                        device="cpu")
    assert isinstance(r2.last_operation, top.Add)
    assert r2.last_operation.value == "bare"
    r2.checkpoint_tiered(str(tmp_path / "ck3"))
    r3 = tengine.TpuTree.restore_tiered(str(tmp_path / "ck3"),
                                        device="cpu")
    assert r3.last_operation == r2.last_operation


def test_restore_without_a_card_refuses(tmp_path):
    """``restore_tiered`` resolves its device like every entry point:
    the card unless named, and it raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    t = fresh_tiered(T, tmp_path / "d", n=40)
    t.checkpoint_tiered(str(tmp_path / "d"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.TpuTree.restore_tiered(str(tmp_path / "d"))
    r = tengine.TpuTree.restore_tiered(str(tmp_path / "d"), device="cpu")
    assert r.device == torch.device("cpu") and r.log_length == 40
