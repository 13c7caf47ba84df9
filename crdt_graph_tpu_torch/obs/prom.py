"""Prometheus-style text exposition (``GET /metrics/prom``) and the
strict mini-parser the tests and the smoke gate pin it with.

One scrape surface merges the four telemetry sources that previously
lived behind four different JSON shapes:

- per-document store counters and gauges (``ServedDoc.metrics``);
- the scheduler histograms WITH their bucket bounds (cumulative
  ``_bucket{le=...}`` series, not just the JSON quantile summary);
- the process-wide span registry (``utils.profiling.span``);
- flight-recorder gauges and dump counters.

Naming contract (validated by :func:`parse_text`): every family is
``crdt_``-prefixed; counters end ``_total``; histograms expose
``_bucket``/``_sum``/``_count`` with ascending ``le`` ending in
``+Inf`` and cumulative counts.  The exposition format targets the
text format v0.0.4 (the one every Prometheus scraper speaks).
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


_UNESCAPE_RE = re.compile(r"\\(.)")


def _unescape(v: str) -> str:
    """Inverse of :func:`_escape` — one left-to-right pass so an
    escaped backslash never re-triggers on the following char."""
    return _UNESCAPE_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), v)


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Writer:
    """Accumulates families in declaration order; one HELP/TYPE block
    per family, samples appended under it."""

    def __init__(self):
        self._order: List[str] = []
        self._fams: Dict[str, Tuple[str, str, List[str]]] = {}

    def family(self, name: str, ftype: str, help_text: str) -> None:
        if name not in self._fams:
            self._order.append(name)
            self._fams[name] = (ftype, help_text, [])

    def sample(self, family: str, name: str, value: float,
               labels: Optional[Dict[str, str]] = None) -> None:
        self._fams[family][2].append(
            f"{name}{_fmt_labels(labels or {})} {_fmt_value(value)}")

    def counter(self, name: str, help_text: str, value: float,
                labels: Optional[Dict[str, str]] = None) -> None:
        self.family(name, "counter", help_text)
        self.sample(name, name, value, labels)

    def gauge(self, name: str, help_text: str, value: float,
              labels: Optional[Dict[str, str]] = None) -> None:
        self.family(name, "gauge", help_text)
        self.sample(name, name, value, labels)

    def histogram(self, name: str, help_text: str,
                  bounds: Sequence[float], counts: Sequence[int],
                  total: int, total_sum: float,
                  labels: Optional[Dict[str, str]] = None) -> None:
        """``counts`` are PER-BUCKET (len(bounds)+1, last = overflow);
        emitted cumulative with the standard ``le`` series."""
        self.family(name, "histogram", help_text)
        labels = labels or {}
        cum = 0
        for b, c in zip(bounds, counts):
            cum += c
            self.sample(name, f"{name}_bucket", cum,
                        {**labels, "le": _fmt_value(b)})
        self.sample(name, f"{name}_bucket", total,
                    {**labels, "le": "+Inf"})
        self.sample(name, f"{name}_sum", total_sum, labels)
        self.sample(name, f"{name}_count", total, labels)

    def render(self) -> str:
        out: List[str] = []
        for name in self._order:
            ftype, help_text, samples = self._fams[name]
            out.append(f"# HELP {name} {help_text}")
            out.append(f"# TYPE {name} {ftype}")
            out.extend(samples)
        return "\n".join(out) + "\n"


def render_engine(engine) -> str:
    """The unified scrape for a ``ServingEngine``: doc counters/gauges,
    scheduler histograms with bucket bounds, scheduler counters, the
    span registry, and flight gauges, one text body."""
    from ..utils import profiling

    w = _Writer()

    # -- per-document store counters + gauges + histograms ---------------
    doc_counters = (
        ("crdt_doc_ops_merged_total", "Leaves merged into the document",
         "ops_merged"),
        ("crdt_doc_dup_absorbed_total", "Duplicate leaves absorbed",
         "dup_absorbed"),
        ("crdt_doc_batches_rejected_total",
         "Deltas rejected for causality gaps", "batches_rejected"),
        ("crdt_doc_admission_rejected_total",
         "Writes shed at admission (429)", "admission_rejected"),
        ("crdt_doc_chunks_launched_total",
         "Kernel chunks launched", "chunks_launched"),
    )
    doc_gauges = (
        ("crdt_doc_queue_depth", "Pending write tickets",
         lambda d, s: len(d.queue)),
        ("crdt_doc_queue_leaves", "Pending leaves across tickets",
         lambda d, s: d.queue.pending_leaves()),
        ("crdt_doc_snapshot_seq", "Published snapshot sequence",
         lambda d, s: s.seq),
        ("crdt_doc_snapshot_age_seconds",
         "Age of the published snapshot", lambda d, s: s.age_s()),
        ("crdt_doc_log_length", "Applied operation log length",
         lambda d, s: s.log_length),
        ("crdt_doc_visible_nodes", "Visible values in the snapshot",
         lambda d, s: len(s.values)),
    )
    docs = engine.docs()
    for name, help_text, attr in doc_counters:
        w.family(name, "counter", help_text)
        for d in docs:
            w.sample(name, name, getattr(d, attr), {"doc": d.doc_id})
    for name, help_text, fn in doc_gauges:
        w.family(name, "gauge", help_text)
        for d in docs:
            w.sample(name, name, fn(d, d.snapshot_view()),
                     {"doc": d.doc_id})
    for name, help_text, attr in (
            ("crdt_doc_commit_latency_ms",
             "Commit latency per coalesced merge round", "commit_ms"),
            ("crdt_doc_coalesce_width",
             "Tickets fused per commit", "coalesce_width")):
        w.family(name, "histogram", help_text)
        for d in docs:
            h = getattr(d, attr).export()
            w.histogram(name, help_text, h["bounds"], h["counts"],
                        h["count"], h["sum"], {"doc": d.doc_id})

    # -- cascade op-log tiers (oplog.py; docs/OPLOG.md) -------------------
    # per-tier occupancy/footprint gauges, spill/compaction/GC
    # counters, the stability watermark, and the cold-segment
    # load-latency histogram (the restore path's cost signal)
    oplog_counters = (
        ("crdt_oplog_spills_total",
         "Hot-tail spills into cold segments", "spills"),
        ("crdt_oplog_compactions_total",
         "Checkpoint-base advancements (cold folds)", "compactions"),
        ("crdt_oplog_segments_gc_total",
         "Cold segments folded into the base and collected",
         "segments_gc"),
        ("crdt_oplog_segment_loads_total",
         "Cold segment/base-chunk loads (cache misses)",
         "segment_loads"),
        ("crdt_oplog_cache_evictions_total",
         "Segment/chunk LRU evictions (GRAFT_OPLOG_CACHE_MB)",
         "cache_evictions"),
    )
    oplog_gauges = (
        ("crdt_oplog_resident_bytes",
         "Estimated resident op-log bytes (hot + indexes + cache)",
         "resident_bytes"),
        ("crdt_oplog_stable_mark",
         "Causal-stability watermark (GC-safe log position)",
         "stable_mark"),
        ("crdt_oplog_gc_deferred_segments",
         "Collected segment files deferred by pinned views",
         "gc_deferred"),
    )
    tele = [(d, d.tree._log.telemetry()) for d in docs]
    for name, help_text, key in oplog_counters:
        w.family(name, "counter", help_text)
        for d, t in tele:
            w.sample(name, name, t[key], {"doc": d.doc_id})
    for name, help_text, key in oplog_gauges:
        w.family(name, "gauge", help_text)
        for d, t in tele:
            w.sample(name, name, t[key], {"doc": d.doc_id})
    w.family("crdt_oplog_tier_ops", "gauge",
             "Ops held per op-log tier")
    w.family("crdt_oplog_tier_bytes", "gauge",
             "Bytes per op-log tier (hot resident, cold/base on disk)")
    for d, t in tele:
        for tier, ops_key, bytes_key in (
                ("hot", "hot_ops", "hot_bytes"),
                ("cold", "cold_ops", "cold_file_bytes"),
                ("base", "base_ops", "base_file_bytes")):
            lbl = {"doc": d.doc_id, "tier": tier}
            w.sample("crdt_oplog_tier_ops", "crdt_oplog_tier_ops",
                     t[ops_key], lbl)
            w.sample("crdt_oplog_tier_bytes", "crdt_oplog_tier_bytes",
                     t[bytes_key], lbl)
    w.family("crdt_oplog_segment_load_ms", "histogram",
             "Cold-segment load latency (the restore path)")
    for d, t in tele:
        h = t["load_ms"]
        if h is not None:
            w.histogram("crdt_oplog_segment_load_ms",
                        "Cold-segment load latency (the restore path)",
                        h["bounds"], h["counts"], h["count"], h["sum"],
                        {"doc": d.doc_id})

    # -- encoded-body read cache (serve/snapshot.py) ------------
    # per-doc hit/miss/bytes counters of the per-generation wire-body
    # cache + the window LRU, and the conditional-GET 304 counter
    rdocs = [(d, d.readcache.snapshot()) for d in docs
             if getattr(d, "readcache", None) is not None]
    if rdocs:
        w.gauge("crdt_readcache_enabled",
                "1 when the encoded-body cache stores bodies "
                "(GRAFT_READCACHE)", 1.0)
        for name, help_text, key in (
                ("crdt_readcache_hits_total",
                 "Reads served from a cached encoded body", "hits"),
                ("crdt_readcache_misses_total",
                 "Reads that encoded a body (first touch per "
                 "generation, or cache disabled)", "misses"),
                ("crdt_readcache_encoded_bytes_total",
                 "Bytes encoded on cache misses (the egress work "
                 "actually paid)", "encoded_bytes"),
                ("crdt_readcache_window_evictions_total",
                 "Window-LRU entries evicted "
                 "(GRAFT_READCACHE_WINDOWS)", "window_evictions"),
                ("crdt_readcache_not_modified_total",
                 "Conditional GETs answered 304 off the ETag "
                 "contract", "not_modified")):
            w.family(name, "counter", help_text)
            for d, rc in rdocs:
                w.sample(name, name, rc[key], {"doc": d.doc_id})

    # -- watch/subscription fan-out (serve/watch.py) ------------
    # per-doc registry occupancy plus the delivery-class counters and
    # the notify latency histogram (pointer swap -> delivery)
    wch = [(d, d.watch) for d in docs
           if getattr(d, "watch", None) is not None]
    if wch:
        w.family("crdt_watch_parked", "gauge",
                 "Watchers currently parked on the publish pointer")
        w.family("crdt_watch_registered", "gauge",
                 "Watcher slots currently admitted (parked + in "
                 "flight)")
        w.family("crdt_watch_max", "gauge",
                 "Per-doc watcher admission cap (GRAFT_WATCH_MAX)")
        for d, reg in wch:
            c = reg.counts()
            lbl = {"doc": d.doc_id}
            w.sample("crdt_watch_parked", "crdt_watch_parked",
                     c["parked"], lbl)
            w.sample("crdt_watch_registered", "crdt_watch_registered",
                     c["registered"], lbl)
            w.sample("crdt_watch_max", "crdt_watch_max", c["max"], lbl)
        for name, help_text, key in (
                ("crdt_watch_admitted_total",
                 "Watch requests admitted past the registry cap",
                 "admitted"),
                ("crdt_watch_rejected_total",
                 "Watch requests shed 429 at the registry door",
                 "rejected"),
                ("crdt_watch_notifies_total",
                 "Deliveries to a parked watcher (woken by a "
                 "publish)", "notifies"),
                ("crdt_watch_resumes_total",
                 "Immediate deliveries (the window already had ops)",
                 "resumes"),
                ("crdt_watch_heartbeats_total",
                 "Empty park-timeout responses and SSE keepalives",
                 "heartbeats"),
                ("crdt_watch_shed_slow_total",
                 "Slow consumers handed back to polling "
                 "(X-Watch-Event: shed)", "shed_slow"),
                ("crdt_watch_reaped_total",
                 "Dead watcher connections found at write time",
                 "reaped")):
            w.family(name, "counter", help_text)
            for d, reg in wch:
                w.sample(name, name, getattr(reg.stats, key),
                         {"doc": d.doc_id})
        w.family("crdt_watch_notify_ms", "histogram",
                 "Notify latency: publish pointer swap to watcher "
                 "delivery")
        for d, reg in wch:
            h = reg.stats.notify_ms.export()
            w.histogram("crdt_watch_notify_ms",
                        "Notify latency: publish pointer swap to "
                        "watcher delivery",
                        h["bounds"], h["counts"], h["count"], h["sum"],
                        {"doc": d.doc_id})

    # -- reactor egress tier (serve/reactor.py) -----------------
    # the selector-loop delivery tier: parked-connection occupancy, loop
    # activity, partial-write continuations, egress-buffer accounting and
    # the shed/reap/re-injection counters (absent from a store without
    # a reactor, the legacy DocumentStore).
    reactor = getattr(engine, "reactor", None)
    if reactor is not None:
        snap = reactor.snapshot()
        for name, help_text, key in (
                ("crdt_reactor_parked",
                 "Watch connections parked on reactor selector loops",
                 "parked"),
                ("crdt_reactor_parked_peak",
                 "High-water mark of reactor-parked connections",
                 "parked_peak"),
                ("crdt_reactor_threads",
                 "Reactor loop threads running "
                 "(GRAFT_REACTOR_THREADS, capped at 4)", "threads"),
                ("crdt_reactor_started",
                 "1 once the first park lazily spawned the loops",
                 "started"),
                ("crdt_reactor_egress_buffer_bytes",
                 "Bytes queued in per-connection egress buffers",
                 "egress_buffer_bytes"),
                ("crdt_reactor_egress_buffer_high_water_bytes",
                 "Largest single-connection egress backlog observed",
                 "buf_hw"),
                ("crdt_reactor_timer_depth",
                 "Connections filed on the heartbeat/deadline timing "
                 "wheel", "timer_depth")):
            w.gauge(name, help_text, snap[key])
        for name, help_text, key in (
                ("crdt_reactor_detached_total",
                 "Watch connections handed off from a handler thread "
                 "to the reactor", "detached"),
                ("crdt_reactor_loops_total",
                 "Selector loop iterations across reactor threads",
                 "loops"),
                ("crdt_reactor_wakeups_total",
                 "Cross-thread wake-pipe signals drained", "wakeups"),
                ("crdt_reactor_notified_total",
                 "Publish deliveries written from a reactor loop",
                 "notified"),
                ("crdt_reactor_partial_writes_total",
                 "Non-blocking writes that hit EAGAIN or a short "
                 "send and re-armed EPOLLOUT", "partial_writes"),
                ("crdt_reactor_timers_fired_total",
                 "Timing-wheel expirations (heartbeats + park "
                 "deadlines)", "timers_fired"),
                ("crdt_reactor_reaps_total",
                 "Parked connections reaped on EOF/socket error",
                 "reaps"),
                ("crdt_reactor_reinjects_total",
                 "Keep-alive sockets re-injected into handler "
                 "threads for a pipelined request", "reinjects"),
                ("crdt_reactor_closes_total",
                 "Named closes written during registry shutdown",
                 "closes")):
            w.family(name, "counter", help_text)
            w.sample(name, name, snap[key], {})
        w.family("crdt_reactor_sheds_total", "counter",
                 "Reactor-side slow-consumer sheds by reason")
        w.sample("crdt_reactor_sheds_total", "crdt_reactor_sheds_total",
                 snap["sheds_buffer"], {"reason": "buffer"})

    # -- scrub & repair (docs/DURABILITY.md §Scrub & repair) --------------
    # rendered per tiered doc: the bit-rot sweep's verified/corrupt/
    # repaired counters plus the live quarantined-segment gauge
    sdocs = [(d, getattr(d, "scrub_stats", None), t)
             for d, t in tele if t["tiered"]]
    sdocs = [(d, st, t) for d, st, t in sdocs if st is not None]
    if sdocs:
        for name, help_text, key in (
                ("crdt_scrub_runs_total",
                 "Checksum scrub passes completed", "runs"),
                ("crdt_scrub_files_checked_total",
                 "Tier/matz files checksum-verified by scrub",
                 "checked"),
                ("crdt_scrub_corrupt_total",
                 "Corrupt tier files found and quarantined",
                 "corrupt"),
                ("crdt_scrub_repaired_total",
                 "Quarantined ranges healed from a fleet peer",
                 "repaired"),
                ("crdt_scrub_repair_failed_total",
                 "Repair attempts that found no usable peer",
                 "repair_failed"),
                ("crdt_scrub_matz_dropped_total",
                 "Corrupt matz artifacts dropped (re-derived at the "
                 "next cadence)", "matz_dropped"),
                # WAL-stream sweep: framing +
                # crc32 walked on the same cadence — mid-log damage
                # surfaces HERE (plus a flight dump), not at recovery
                ("crdt_scrub_wal_records_total",
                 "WAL records framing+crc-verified by the scrub "
                 "sweep", "wal_records"),
                ("crdt_scrub_wal_torn_tail_total",
                 "Torn WAL tails seen by scrub (crash leftovers or "
                 "an append racing the sweep — benign)",
                 "wal_torn_tail"),
                ("crdt_scrub_wal_mid_log_total",
                 "Mid-log WAL corruption found by scrub (typed "
                 "WalError class; flight-dumped)", "wal_mid_log")):
            w.family(name, "counter", help_text)
            for d, st, t in sdocs:
                w.sample(name, name, st.get(key, 0), {"doc": d.doc_id})
        w.family("crdt_scrub_quarantined_segments", "gauge",
                 "Tier files currently quarantined (typed refusals "
                 "until repaired)")
        for d, st, t in sdocs:
            w.sample("crdt_scrub_quarantined_segments",
                     "crdt_scrub_quarantined_segments",
                     t.get("quarantined", 0), {"doc": d.doc_id})

    # -- write-ahead log (wal.py; docs/DURABILITY.md) ---------------------
    # rendered only when at least one document is durable, so the
    # default ephemeral engine's scrape is unchanged
    wdocs = [(d, d.wal.telemetry()) for d in docs if d.wal is not None]
    if wdocs:
        shared_mode = getattr(engine, "shared_wal", None) is not None
        wal_counters = [
            ("crdt_wal_appends_total",
             "Commit records appended to the WAL", "appends"),
            ("crdt_wal_appended_bytes_total",
             "Bytes appended to the WAL", "appended_bytes"),
            ("crdt_wal_truncations_total",
             "WAL prefix truncations at spill/fold watermarks",
             "truncations"),
            ("crdt_wal_replay_records_total",
             "Records replayed at the last recovery",
             "replay_records"),
            ("crdt_wal_torn_tail_dropped_total",
             "Torn final records dropped at recovery",
             "torn_dropped"),
        ]
        if not shared_mode:
            # stream-scoped series render per-doc only when every doc
            # HAS its own stream; in shared mode they live ONCE under
            # crdt_wal_shared_* (a per-doc rendering would repeat the
            # whole stream's totals once per document)
            wal_counters += [
                ("crdt_wal_fsyncs_total",
                 "WAL fsyncs (one may cover a whole group commit)",
                 "fsyncs"),
                ("crdt_wal_errors_total",
                 "WAL append/fsync failures (shed as 503)", "errors"),
            ]
        for name, help_text, key in wal_counters:
            w.family(name, "counter", help_text)
            for d, t in wdocs:
                w.sample(name, name, t[key], {"doc": d.doc_id})
        if not shared_mode:
            w.family("crdt_wal_size_bytes", "gauge",
                     "Current WAL file size (O(hot tail) "
                     "steady-state)")
            for d, t in wdocs:
                w.sample("crdt_wal_size_bytes", "crdt_wal_size_bytes",
                         t["size_bytes"], {"doc": d.doc_id})
        w.family("crdt_wal_epoch", "gauge",
                 "Fencing epoch (bumped at every recovery-to-serving)")
        for d, t in wdocs:
            w.sample("crdt_wal_epoch", "crdt_wal_epoch", d.epoch,
                     {"doc": d.doc_id})
        if not shared_mode:
            w.family("crdt_wal_fsync_ms", "histogram",
                     "WAL fsync latency (the durability tax per "
                     "sync)")
            for d, t in wdocs:
                h = t["fsync_ms"]
                if h is not None:
                    w.histogram("crdt_wal_fsync_ms",
                                "WAL fsync latency (the durability "
                                "tax per sync)",
                                h["bounds"], h["counts"], h["count"],
                                h["sum"], {"doc": d.doc_id})

    # -- persisted materialization (docs/DURABILITY.md §Cold paths) -------
    # rendered only for durable engines, like the WAL families
    if getattr(engine, "durable_dir", None) is not None and docs:
        matz_counters = (
            ("crdt_matz_writes_total",
             "Materialization artifacts written", "writes"),
            ("crdt_matz_loads_total",
             "Restores whose first read came off the artifact",
             "loads"),
            ("crdt_matz_fallbacks_total",
             "Artifacts unusable — fell back to the full first merge",
             "fallbacks"),
            ("crdt_matz_tail_replayed_total",
             "Ops replayed past artifact coverage at load",
             "tail_replayed"),
        )
        for name, help_text, key in matz_counters:
            w.family(name, "counter", help_text)
            for d in docs:
                w.sample(name, name, d.tree.matz_stats[key],
                         {"doc": d.doc_id})
        w.family("crdt_matz_covered_ops", "gauge",
                 "Log ops covered by the live artifact")
        for d, t in tele:
            w.sample("crdt_matz_covered_ops", "crdt_matz_covered_ops",
                     t["matz_len"], {"doc": d.doc_id})

    # -- shared group-commit WAL stream (GRAFT_WAL_SHARED) ----------------
    shared = getattr(engine, "shared_wal", None)
    if shared is not None:
        st = shared.telemetry()
        for name, help_text, key in (
                ("crdt_wal_shared_appends_total",
                 "Commit records appended to the shared stream",
                 "appends"),
                ("crdt_wal_shared_appended_bytes_total",
                 "Bytes appended to the shared stream",
                 "appended_bytes"),
                ("crdt_wal_shared_fsyncs_total",
                 "Shared-stream fsyncs (ONE covers every document "
                 "in the round)", "fsyncs"),
                ("crdt_wal_shared_compactions_total",
                 "Stream compactions at per-doc durable marks",
                 "compactions"),
                ("crdt_wal_shared_errors_total",
                 "Shared-stream append/fsync failures", "errors"),
                ("crdt_wal_shared_torn_tail_dropped_total",
                 "Torn final records dropped at recovery",
                 "torn_dropped")):
            w.counter(name, help_text, st[key])
        w.gauge("crdt_wal_shared_size_bytes",
                "Shared stream size (O(sum of hot tails))",
                st["size_bytes"])
        w.gauge("crdt_wal_shared_docs_marked",
                "Documents with a durable truncation mark",
                st["docs_marked"])
        for hname, hkey, htext in (
                ("crdt_wal_shared_fsync_ms", "fsync_ms",
                 "Shared fsync latency (the whole round's tax, once)"),
                ("crdt_wal_shared_covered_docs", "covered_docs",
                 "Documents covered per shared fsync (the "
                 "amortization)")):
            h = st[hkey]
            if h is not None:
                w.family(hname, "histogram", htext)
                w.histogram(hname, htext, h["bounds"], h["counts"],
                            h["count"], h["sum"])

    # -- pipelined commit path (serve/workers.py) ---------------
    sync_worker = getattr(engine, "sync_worker", None)
    w.gauge("crdt_sched_pipeline_enabled",
            "1 when the two-stage commit pipeline is armed "
            "(durable batch mode)",
            1.0 if sync_worker is not None else 0.0)
    if sync_worker is not None:
        ps = sync_worker.stats()
        w.counter("crdt_sched_pipeline_rounds_total",
                  "Rounds whose group fsync rode the WAL-sync worker",
                  ps["jobs_done"])
        w.counter("crdt_sched_pipeline_commits_synced_total",
                  "Commits resolved by the WAL-sync worker",
                  ps["commits_synced"])
        w.counter("crdt_sched_pipeline_commits_shed_total",
                  "Commits shed by a failed pipelined fsync",
                  ps["commits_shed"])
        w.gauge("crdt_sched_pipeline_inflight",
                "Fsync jobs queued or executing on the sync worker",
                ps["inflight"])
        # -- sync-backend fan-out (docs/DURABILITY.md §Sync
        # backends): which lane the group-commit fsyncs ride, and how
        # many are genuinely in flight on it right now — the A/B legs
        # attribute fsync_wait to the right backend off these
        w.gauge("crdt_wal_sync_backend",
                "1 for the active group-commit sync backend "
                "(GRAFT_WAL_SYNC_BACKEND)", 1.0,
                {"backend": ps["backend"],
                 "requested": ps["backend_requested"]})
        w.gauge("crdt_wal_sync_inflight",
                "Per-doc fsyncs currently in flight on the sync lane "
                "(popped from the queue, durability not yet resolved)",
                ps["sync_inflight"])

    # -- host-shared encoded-body tier (serve/shmcache.py) ----------------
    # rendered only when GRAFT_SHMCACHE armed a cache on a readcache-on
    # engine — the default scrape is unchanged, like crdt_wal_*
    shmcache = getattr(engine, "shmcache", None)
    if shmcache is not None:
        st = shmcache.stats.snapshot()
        for name, help_text, key in (
                ("crdt_shmcache_hits_total",
                 "Generations served by attaching a segment another "
                 "process encoded", "hits"),
                ("crdt_shmcache_misses_total",
                 "Generations this process encoded and published to "
                 "the shared tier", "misses"),
                ("crdt_shmcache_attach_failed_total",
                 "Shared-tier degradations to the process-local path",
                 "attach_failed"),
                ("crdt_shmcache_shared_bytes_total",
                 "Payload bytes served out of shared segments",
                 "shared_bytes"),
                ("crdt_shmcache_released_total",
                 "Generation claims released at publish swaps and "
                 "shutdown", "released"),
                ("crdt_shmcache_scavenged_total",
                 "Dead-process segments unlinked by the scavenger",
                 "scavenged")):
            w.counter(name, help_text, st[key])
    # -- zero-copy cold egress (oplog.py wire sidecars) ---------
    # rendered only on a tiering engine — same presence gating as
    # crdt_wal_*
    sendfile = getattr(engine, "sendfile_stats", None)
    if sendfile is not None:
        st = sendfile.snapshot()
        for name, help_text, key in (
                ("crdt_sendfile_windows_total",
                 "Catch-up /ops windows shipped zero-copy via "
                 "os.sendfile", "windows"),
                ("crdt_sendfile_bytes_total",
                 "Sidecar file bytes shipped zero-copy (page cache "
                 "to socket, never materialized in-process)",
                 "file_bytes"),
                ("crdt_sendfile_fallback_total",
                 "Cold-window plan attempts that fell back to the "
                 "buffered path (sidecar building/refused/vanished)",
                 "fallback"),
                ("crdt_sendfile_sidecar_builds_total",
                 "Wire sidecars built or reopened ready to serve",
                 "sidecar_builds"),
                ("crdt_sendfile_sidecar_build_failures_total",
                 "Sidecar build/load attempts that failed "
                 "(quarantine, verify mismatch, I/O error)",
                 "sidecar_build_failures")):
            w.counter(name, help_text, st.get(key, 0))
    # -- ops-axis sharded merge routing (parallel/opsaxis.py) ---
    from ..parallel import opsaxis as opsaxis_mod
    ax = opsaxis_mod.stats()
    w.gauge("crdt_opsaxis_enabled",
            "1 when GRAFT_OPSAXIS routing is armed on this host",
            1.0 if ax["enabled"] else 0.0)
    w.gauge("crdt_opsaxis_devices",
            "Ops-axis mesh width (largest pow2 <= local devices)",
            ax["devices"] or opsaxis_mod.mesh_devices())
    w.gauge("crdt_opsaxis_min_ops",
            "Sharded-route threshold (GRAFT_OPSAXIS_MIN_OPS)",
            ax["min_ops"])
    w.gauge("crdt_opsaxis_halo_rows",
            "Static halo rows per shard edge of the windowed plane "
            "sweeps", ax["halo_rows"])
    w.counter("crdt_opsaxis_merges_total",
              "Merges routed to the ops-axis sharded kernel",
              ax["merges"])
    w.counter("crdt_opsaxis_routed_ops_total",
              "Candidate-set rows merged through the sharded kernel",
              ax["routed_ops"])
    # -- disaggregated merge tier (mergetier/; docs/MERGETIER.md) ---------
    # rendered ONLY when a client is armed — GRAFT_MERGETIER=0 (or no
    # workers) leaves the scrape byte-identical to the local-only engine
    mergetier = getattr(engine, "mergetier", None)
    if mergetier is not None:
        mst = mergetier.stats()
        w.gauge("crdt_mergetier_workers",
                "Merge workers in this front-end's pool",
                len(mst["workers"]))
        w.gauge("crdt_mergetier_workers_open",
                "Pool members whose circuit breaker is open",
                sum(1 for ws in mst["workers"] if ws["breaker_open"]))
        w.counter("crdt_mergetier_breaker_opens_total",
                  "Worker breaker open transitions",
                  sum(ws["breaker_opens"] for ws in mst["workers"]))
        w.counter("crdt_mergetier_rounds_total",
                  "Scheduler rounds shipped to the merge tier",
                  mst["remote_rounds"])
        w.counter("crdt_mergetier_remote_docs_total",
                  "Document commits whose frame a merge worker "
                  "materialized", mst["remote_docs"])
        w.counter("crdt_mergetier_remote_ops_total",
                  "Delta rows committed off remote-materialized "
                  "frames", mst["remote_ops"])
        w.family("crdt_mergetier_fallbacks_total", "counter",
                 "Remote merges that fell back to the bit-identical "
                 "local path, by ladder rung")
        for reason, cnt in sorted(mst["fallbacks"].items()):
            w.sample("crdt_mergetier_fallbacks_total",
                     "crdt_mergetier_fallbacks_total", cnt,
                     {"reason": reason})
        for hname, hkey, htext in (
                ("crdt_mergetier_batch_width", "width",
                 "Worker-reported cross-fleet launch width each "
                 "remote commit rode in"),
                ("crdt_mergetier_remote_ms", "remote_ms",
                 "Remote merge round-trip latency (encode to "
                 "verified frame)")):
            h = mst[hkey]
            if h and h.get("count"):
                w.family(hname, "histogram", htext)
                w.histogram(hname, htext, h["bounds"], h["counts"],
                            h["count"], h["sum"])
    maint = getattr(engine, "maintenance", None)
    if maint is not None:
        ms = maint.stats()
        w.gauge("crdt_maint_queue_depth",
                "Maintenance tasks queued or executing",
                ms["queue_depth"])
        w.family("crdt_maint_tasks_total", "counter",
                 "Background maintenance tasks completed, by kind")
        for kind in sorted(ms["tasks_done"]):
            w.sample("crdt_maint_tasks_total", "crdt_maint_tasks_total",
                     ms["tasks_done"][kind], {"kind": kind})
        w.counter("crdt_maint_task_errors_total",
                  "Maintenance tasks that failed (counted, non-fatal)",
                  ms["task_errors"])
        w.counter("crdt_maint_queue_full_total",
                  "Maintenance enqueues dropped on a full queue",
                  ms["queue_full_drops"])
        w.counter("crdt_maint_inline_spill_fallbacks_total",
                  "Hard-cap spills run inline on the scheduler "
                  "because the worker lagged",
                  ms["inline_spill_fallbacks"])
        w.counter("crdt_maint_policy_age_spills_total",
                  "Spills triggered by the hot-tail age policy",
                  ms["policy_age_spills"])
        w.counter("crdt_maint_policy_resident_spills_total",
                  "Spills triggered by the engine-wide resident-bytes "
                  "policy", ms["policy_resident_spills"])
        for hname, hkey, htext in (
                ("crdt_maint_task_ms", "task_ms",
                 "Maintenance task execution latency"),
                ("crdt_maint_matz_export_ms", "matz_export_ms",
                 "Background matz artifact serialize+publish "
                 "latency")):
            h = ms[hkey]
            if h and h.get("count"):
                w.family(hname, "histogram", htext)
                w.histogram(hname, htext, h["bounds"], h["counts"],
                            h["count"], h["sum"])

    # -- engine-wide scheduler counters ----------------------------------
    for cname, val in sorted(engine.counters.snapshot().items()):
        safe = re.sub(r"[^a-zA-Z0-9_]", "_", cname)
        w.counter(f"crdt_scheduler_{safe}_total",
                  f"Scheduler counter {cname}", val)

    # -- span registry ---------------------------------------------------
    spans = profiling.span_stats()
    w.family("crdt_span_ms_total", "counter",
             "Accumulated wall ms per span")
    w.family("crdt_span_calls_total", "counter",
             "Invocations per span")
    w.family("crdt_span_max_ms", "gauge",
             "Max single invocation ms per span")
    for sname, s in sorted(spans.items()):
        lbl = {"span": sname}
        w.sample("crdt_span_ms_total", "crdt_span_ms_total",
                 s["total_ms"], lbl)
        w.sample("crdt_span_calls_total", "crdt_span_calls_total",
                 s["count"], lbl)
        w.sample("crdt_span_max_ms", "crdt_span_max_ms",
                 s["max_ms"], lbl)

    # -- flight recorder -------------------------------------------------
    fs = engine.flight.stats()
    w.gauge("crdt_flight_records", "Commit records in the ring",
            fs["records"])
    w.counter("crdt_flight_records_total", "Commit records ever",
              fs["records_total"])
    w.counter("crdt_flight_slo_breaches_total",
              "Commits over the SLO threshold", fs["slo_breaches"])
    w.counter("crdt_flight_audit_failures_total",
              "Sampled chain audits with ok=false",
              fs["audit_failures"])
    w.counter("crdt_flight_errors_total",
              "Commits resolved with an engine error", fs["errors"])
    w.family("crdt_flight_dumps_total", "counter",
             "Automatic + manual flight dumps by reason")
    for reason, n in sorted(fs["dumps"].items()):
        w.sample("crdt_flight_dumps_total", "crdt_flight_dumps_total",
                 n, {"reason": reason})
    w.gauge("crdt_flight_slo_ms", "Configured commit SLO threshold",
            fs["slo_ms"])
    w.gauge("crdt_flight_last_commit_ms",
            "Latency of the most recent commit", fs["last_commit_ms"])

    # -- session-guarantee oracle (when one is attached) ------------------
    oracle = getattr(engine, "oracle", None)
    if oracle is not None:
        ost = oracle.stats()
        w.counter("crdt_oracle_sessions_total",
                  "Distinct sessions the oracle has observed",
                  ost["sessions"])
        w.counter("crdt_oracle_commits_ingested_total",
                  "Flight commit records the oracle consumed",
                  ost["commits_ingested"])
        for check in sorted(ost["checks"]):
            w.counter("crdt_oracle_checks_total",
                      "Session-guarantee checks evaluated, by check",
                      ost["checks"][check], {"check": check})
            w.counter("crdt_oracle_violations_total",
                      "Session-guarantee violations detected, by check",
                      ost["violations"].get(check, 0), {"check": check})
        w.gauge("crdt_oracle_pending_writes",
                "Acked writes awaiting commit-record resolution",
                ost["pending_writes"])
    return w.render()


def render_merge_worker(worker) -> str:
    """The ``crdt_mergetier_worker_*`` families for one merge worker
    process (``GET /metrics/prom`` on a worker server — same naming
    contract and strict parser as the engine scrape).  The linger
    batcher's occupancy and launch-width distribution live HERE: the
    worker is the only process that sees the cross-fleet batch."""
    w = _Writer()
    st = worker.stats()
    w.gauge("crdt_mergetier_worker_up",
            "0 after crash()/close(): the worker answers 503",
            0.0 if st["dead"] else 1.0)
    w.counter("crdt_mergetier_worker_requests_total",
              "Decoded /merge requests admitted to the batcher",
              st["requests"])
    w.counter("crdt_mergetier_worker_merged_docs_total",
              "Documents materialized and answered", st["merged_docs"])
    w.counter("crdt_mergetier_worker_merged_ops_total",
              "Delta rows across answered documents", st["merged_ops"])
    w.counter("crdt_mergetier_worker_wire_errors_total",
              "Requests rejected by the wire codec (400s)",
              st["wire_errors"])
    w.counter("crdt_mergetier_worker_launch_errors_total",
              "Requests failed by a failed epoch launch (500s)",
              st["launch_errors"])
    b = st["batcher"]
    w.counter("crdt_mergetier_worker_launches_total",
              "Batched epoch launches", b["launches"])
    w.counter("crdt_mergetier_worker_full_launches_total",
              "Epochs launched early at the max-width cap",
              b["full_launches"])
    w.counter("crdt_mergetier_worker_linger_waits_total",
              "Epoch leaders that lingered the full window",
              b["linger_waits"])
    w.gauge("crdt_mergetier_worker_linger_occupancy",
            "Requests riding the CURRENT linger window", b["pending"])
    w.gauge("crdt_mergetier_worker_linger_ms",
            "Configured linger window (GRAFT_MERGETIER_BATCH_MS)",
            b["linger_ms"])
    w.gauge("crdt_mergetier_worker_max_width",
            "Configured launch-width cap (GRAFT_MERGETIER_MAX_WIDTH)",
            b["max_width"])
    h = st["batch_width"]
    if h and h.get("count"):
        w.family("crdt_mergetier_worker_batch_width", "histogram",
                 "Achieved cross-fleet docs per epoch launch")
        w.histogram("crdt_mergetier_worker_batch_width",
                    "Achieved cross-fleet docs per epoch launch",
                    h["bounds"], h["counts"], h["count"], h["sum"])
    return w.render()


def render_cluster(node) -> str:
    """The ``crdt_cluster_*`` families for one fleet node
    (cluster/gateway.py appends this to :func:`render_engine`'s text —
    same naming contract, same strict parser).  Anti-entropy **lag** is
    first-class: ``crdt_cluster_antientropy_sync_age_seconds{peer=}``
    is how long ago each peer was last fully pulled — the replication
    staleness an operator alerts on — next to per-peer pull/failure
    counters, the backoff gauge, and the round-latency histogram."""
    cs = node.cluster_stats()
    w = _Writer()
    me = cs["node"]
    w.gauge("crdt_cluster_node_id",
            "This node's leased numeric replica id",
            me["id"], {"node": me["name"]})
    w.gauge("crdt_cluster_lease_epoch",
            "Fencing token of the current lease",
            me["epoch"], {"node": me["name"]})
    if me["lease_remaining_s"] is not None:
        w.gauge("crdt_cluster_lease_remaining_seconds",
                "Time until this node's lease expires unrenewed",
                max(0.0, me["lease_remaining_s"]))
    w.counter("crdt_cluster_lease_losses_total",
              "Times this node's lease was fenced or lost",
              me["lease_losses"])
    w.counter("crdt_cluster_lease_reacquired_total",
              "Times this node re-acquired after a lost lease",
              me["lease_reacquired"])
    w.gauge("crdt_cluster_members", "Live members in the lease table",
            len(cs["members"]))
    w.gauge("crdt_cluster_primary_docs",
            "Local documents whose ring primary is this node",
            sum(1 for p in cs["primaries"].values()
                if p == me["name"]))
    for key, help_text in (
            ("forwarded_ok", "Client writes relayed to a primary"),
            ("forwarded_err",
             "Write forwards that exhausted the retry budget"),
            ("forward_retries", "Forward connection retries"),
            ("forward_budget_exhausted",
             "Forwards cut off by the end-to-end deadline budget"),
            ("forwarded_in",
             "Writes received already forwarded by a peer"),
            ("replica_ids_assigned",
             "Fleet-unique client replica ids allocated"),
            ("staleness_503",
             "Reads refused for exceeding their staleness bound"),
            ("repair_fetches",
             "Quarantined ranges successfully fetched from a peer"),
            ("repair_fetch_failures",
             "Peer-repair fetches that found no usable peer")):
        w.counter(f"crdt_cluster_{key}_total", help_text,
                  cs["counters"].get(key, 0))
    # the bounded-staleness contract's server-side gauge: what
    # X-Ae-Lag-Seconds stamps on every read (docs/CLUSTER.md
    # §Partitions & staleness)
    # cluster_stats keeps the JSON wire RFC-valid by nulling an
    # unbounded (never-synced) lag; the prom text format has a real
    # +Inf, so re-expand it here
    w.gauge("crdt_cluster_ae_lag_seconds",
            "Max seconds since any live peer was last fully synced",
            float("inf") if cs["ae_lag_s"] is None
            else cs["ae_lag_s"])
    ae = cs["antientropy"]
    w.counter("crdt_cluster_antientropy_rounds_total",
              "Anti-entropy rounds completed", ae["rounds"])
    w.counter("crdt_cluster_antientropy_local_shed_total",
              "Pulls shed on the local admission queue",
              ae["local_shed"])
    w.counter("crdt_cluster_antientropy_probe_pulls_total",
              "Bounded open-breaker probe pulls",
              ae["probe_pulls"])
    h = ae["round_ms_export"]
    w.histogram("crdt_cluster_antientropy_round_ms",
                "Anti-entropy round latency", h["bounds"], h["counts"],
                h["count"], h["sum"])
    peer_families = (
        ("crdt_cluster_antientropy_pulls_total", "counter",
         "Windows pulled from the peer", "pulls"),
        ("crdt_cluster_antientropy_ops_applied_total", "counter",
         "Leaves applied from the peer (duplicates excluded)",
         "ops_applied"),
        ("crdt_cluster_antientropy_failures_total", "counter",
         "Failed sync attempts against the peer", "failures"),
        ("crdt_cluster_antientropy_dup_window_304s_total", "counter",
         "Duplicate windows skipped by a bodyless conditional-GET "
         "304", "dup_window_304s"),
        ("crdt_cluster_antientropy_sync_age_seconds", "gauge",
         "Seconds since the peer was last fully synced (the lag)",
         "sync_age_s"),
        ("crdt_cluster_antientropy_backoff_seconds", "gauge",
         "Remaining backoff before the peer is retried", "backoff_s"),
    )
    # per-peer health + circuit breaker (docs/CLUSTER.md §Partitions
    # & staleness): the degradation surface an operator alerts on
    peer_families = peer_families + (
        ("crdt_peer_health", "gauge",
         "Peer success-rate EWMA (1.0 = healthy)", "health"),
        ("crdt_peer_breaker_open", "gauge",
         "1 while the peer's circuit breaker is open "
         "(probes only, no full rounds)", "breaker_open"),
        ("crdt_peer_breaker_opens_total", "counter",
         "Times the peer's circuit breaker tripped open",
         "breaker_opens"),
        ("crdt_peer_probes_total", "counter",
         "Bounded probe pulls sent while the breaker was open",
         "probes"),
    )
    for fname, ftype, help_text, _ in peer_families:
        w.family(fname, ftype, help_text)
    for peer, st in ae["peers"].items():
        for fname, _, _, key in peer_families:
            w.sample(fname, fname, st[key], {"peer": peer})
    # pooled inter-node connections (cluster/pool.py): the
    # persistent-connection proof (reuses ≫ opens on a healthy fleet)
    # and the chaos interaction (poisoned = faults that evicted
    # exactly the pooled connection they hit)
    cp = cs.get("connpool")
    if cp is not None:
        for key, help_text in (
                ("opens", "Pooled connections opened (cache misses)"),
                ("reuses", "Requests served over a reused pooled "
                           "connection"),
                ("evictions", "Pooled connections evicted (idle "
                              "overflow, max-age, server-close)"),
                ("poisoned", "Pooled connections poisoned by a "
                             "transport/chaos failure"),
                ("stale_retries", "Requests retried once after a "
                                  "stale keep-alive reuse")):
            w.counter(f"crdt_connpool_{key}_total", help_text,
                      cp.get(key, 0))
        w.gauge("crdt_connpool_idle_connections",
                "Idle pooled connections held right now",
                cp.get("idle", 0))
        w.gauge("crdt_connpool_links",
                "Distinct (src,dst,host,port) links pooled",
                cp.get("links", 0))
    # deterministic network fault injection (cluster/netchaos.py) —
    # rendered only when a fault plan is armed on this node
    nc = cs.get("netchaos")
    if nc is not None:
        w.gauge("crdt_netchaos_seed",
                "Seed of the armed fault plan (replay key)",
                nc["seed"])
        w.gauge("crdt_netchaos_links",
                "Distinct (src, dst) links the plan has seen",
                nc["links"])
        w.gauge("crdt_netchaos_blocked_links",
                "Links currently cut by a programmatic partition",
                nc["blocked_links"])
        w.counter("crdt_netchaos_requests_total",
                  "Requests that passed through the fault plan",
                  nc["counters"]["requests"])
        w.family("crdt_netchaos_faults_total", "counter",
                 "Faults injected, by kind")
        for kind in ("drops", "delays", "throttles", "cuts", "dups",
                     "partition_blocks"):
            w.sample("crdt_netchaos_faults_total",
                     "crdt_netchaos_faults_total",
                     nc["counters"][kind], {"kind": kind})
    # fleet tracing + visibility ledger + canary (
    # docs/OBSERVABILITY.md §Fleet tracing & visibility ledger) —
    # every family below is ABSENT under GRAFT_FLEETTRACE=0 /
    # GRAFT_CANARY=0 (cluster_stats nulls the sections), the same
    # disabled-tier contract the netchaos families keep
    ft = cs.get("fleettrace")
    if ft is not None:
        w.gauge("crdt_fleettrace_traces",
                "Trace ids held in this node's span ring",
                ft["traces"])
        w.counter("crdt_fleettrace_evicted_traces_total",
                  "Traces FIFO-evicted from the bounded span ring",
                  ft["evicted_traces"])
        w.counter("crdt_fleettrace_federated_fetches_total",
                  "Peer fetches made assembling /debug/trace trees",
                  ft["federated_fetches"])
        w.family("crdt_fleettrace_spans_total", "counter",
                 "Causal spans recorded on this node, by hop kind")
        for kind in sorted(ft["spans_by_kind"]):
            w.sample("crdt_fleettrace_spans_total",
                     "crdt_fleettrace_spans_total",
                     ft["spans_by_kind"][kind], {"kind": kind})
    vis = cs.get("visibility")
    if vis is not None:
        w.counter("crdt_visibility_commits_total",
                  "Commits entered into the visibility ledger",
                  vis["commits"])
        w.counter("crdt_visibility_replica_applies_total",
                  "Anti-entropy frontier applies stamped on this "
                  "node as the puller", vis["replica_applies"])
        w.counter("crdt_visibility_skew_clamped_total",
                  "Cross-node lag bounds clamped at zero (negative "
                  "clock skew)", vis["skew_clamped"])
        if vis["lag"]:
            w.family("crdt_visibility_lag_seconds", "histogram",
                     "Write-to-visibility lag by stage (cross-node "
                     "stages are one-way BOUNDS, not truths)")
            for row in vis["lag"]:
                h = row["hist"]
                w.histogram("crdt_visibility_lag_seconds",
                            "Write-to-visibility lag by stage",
                            h["bounds"], h["counts"], h["count"],
                            h["sum"], {"stage": row["stage"],
                                       "peer": row["peer"]})
    can = cs.get("canary")
    if can is not None:
        w.counter("crdt_canary_probes_total",
                  "Synthetic canary probes written through the real "
                  "admission path", can["probes"])
        w.counter("crdt_canary_slo_breaches_total",
                  "Probes with a stage over GRAFT_CANARY_SLO_MS",
                  can["slo_breaches"])
        w.family("crdt_canary_failures_total", "counter",
                 "Canary hop failures, by hop")
        for hop in sorted(can["failures"]):
            w.sample("crdt_canary_failures_total",
                     "crdt_canary_failures_total",
                     can["failures"][hop], {"hop": hop})
        h = can["e2e"]
        if h.get("count"):
            w.family("crdt_canary_visibility_seconds", "histogram",
                     "Canary write-to-global-visibility, end to end")
            w.histogram("crdt_canary_visibility_seconds",
                        "Canary write-to-global-visibility, end to "
                        "end", h["bounds"], h["counts"], h["count"],
                        h["sum"])
        if can["stages"]:
            w.family("crdt_canary_stage_seconds", "histogram",
                     "Canary per-stage visibility lag "
                     "(ack/watch/peer_first/peer_all)")
            for stage in sorted(can["stages"]):
                h = can["stages"][stage]
                w.histogram("crdt_canary_stage_seconds",
                            "Canary per-stage visibility lag",
                            h["bounds"], h["counts"], h["count"],
                            h["sum"], {"stage": stage})
    return w.render()


class PromParseError(ValueError):
    """The exposition violated the format or the naming contract."""


class PromParseError(ValueError):
    """The exposition violated the format or the naming contract."""


def parse_text(text: str, require_prefix: str = "crdt_"
               ) -> Dict[str, Dict[str, Any]]:
    """Strict parse of the exposition text.

    Returns ``{family: {"type": t, "help": h, "samples":
    [(name, labels, value), ...]}}`` and raises
    :class:`PromParseError` on: samples without a declared family,
    counter families not ending ``_total``, histogram series missing
    ``_bucket``/``_sum``/``_count``, non-cumulative buckets, a missing
    ``+Inf`` bucket, ``_count`` != the ``+Inf`` bucket, or a family
    outside ``require_prefix``.
    """
    fams: Dict[str, Dict[str, Any]] = {}
    current: Optional[str] = None
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            name = parts[2]
            fams.setdefault(name, {"type": None, "help": None,
                                   "samples": []})
            fams[name]["help"] = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            name, ftype = parts[2], parts[3].strip()
            fams.setdefault(name, {"type": None, "help": None,
                                   "samples": []})
            fams[name]["type"] = ftype
            current = name
            if require_prefix and not name.startswith(require_prefix):
                raise PromParseError(
                    f"line {lineno}: family {name!r} outside the "
                    f"{require_prefix!r} namespace")
            if ftype == "counter" and not name.endswith("_total"):
                raise PromParseError(
                    f"line {lineno}: counter {name!r} must end _total")
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise PromParseError(f"line {lineno}: unparseable sample "
                                 f"{line!r}")
        sname, rawlabels, rawval = m.groups()
        labels = {k: _unescape(v) for k, v in
                  _LABEL_RE.findall(rawlabels)} if rawlabels else {}
        value = float(rawval.replace("+Inf", "inf"))
        fam = None
        if current is not None and (
                sname == current or (
                    fams[current]["type"] == "histogram" and
                    sname in (f"{current}_bucket", f"{current}_sum",
                              f"{current}_count"))):
            fam = current
        if fam is None:
            raise PromParseError(
                f"line {lineno}: sample {sname!r} does not belong to "
                f"the current family {current!r}")
        if not _NAME_RE.match(sname):
            raise PromParseError(f"line {lineno}: bad name {sname!r}")
        fams[fam]["samples"].append((sname, labels, value))

    for name, fam in fams.items():
        if fam["type"] is None:
            raise PromParseError(f"family {name!r} has no TYPE")
        if fam["type"] == "histogram":
            _check_histogram(name, fam["samples"])
    return fams


def _check_histogram(name: str,
                     samples: List[Tuple[str, Dict[str, str], float]]
                     ) -> None:
    series: Dict[Tuple[Tuple[str, str], ...],
                 Dict[str, Any]] = {}
    for sname, labels, value in samples:
        key = tuple(sorted((k, v) for k, v in labels.items()
                           if k != "le"))
        s = series.setdefault(key, {"buckets": [], "sum": None,
                                    "count": None})
        if sname == f"{name}_bucket":
            s["buckets"].append((labels.get("le"), value))
        elif sname == f"{name}_sum":
            s["sum"] = value
        elif sname == f"{name}_count":
            s["count"] = value
    for key, s in series.items():
        if not s["buckets"]:
            raise PromParseError(f"{name}{dict(key)}: no buckets")
        les = [le for le, _ in s["buckets"]]
        if les[-1] != "+Inf":
            raise PromParseError(
                f"{name}{dict(key)}: last bucket le={les[-1]!r}, "
                "want +Inf")
        bounds = [float(le.replace("+Inf", "inf")) for le in les]
        if bounds != sorted(bounds):
            raise PromParseError(f"{name}{dict(key)}: le not ascending")
        counts = [v for _, v in s["buckets"]]
        if counts != sorted(counts):
            raise PromParseError(
                f"{name}{dict(key)}: buckets not cumulative")
        if s["count"] is None or s["sum"] is None:
            raise PromParseError(
                f"{name}{dict(key)}: missing _count or _sum")
        if s["count"] != counts[-1]:
            raise PromParseError(
                f"{name}{dict(key)}: _count {s['count']} != +Inf "
                f"bucket {counts[-1]}")
