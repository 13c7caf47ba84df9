"""Serving-engine smoke: concurrent pushes + reads across documents over
real HTTP, then convergence, telemetry-exposition, and clean-shutdown
checks — the port's counterpart of ``scripts/serve_smoke.py``, on the
card unless ``device`` names another.

W writers per document push causally valid deltas under distinct
server-assigned replica ids while readers hammer every read endpoint;
each writer then verifies READ-YOUR-WRITES over the wire (its acked
values must all appear in a follow-up read, whose ``X-Commit-Seq``/
``X-Snapshot-Fingerprint``/``X-Session-Id`` headers identify the serving
snapshot); afterwards each document's ``/ops?since=0`` replay into a
fresh engine must equal its served value sequence, the counters must
account for every pushed op, the unified telemetry surface must hold
(``/metrics/prom`` parses under the strict naming contract and
``/debug/flight`` attributes every commit to the trace ids the pushes
carried, one scrape after the ``ServingEngine.flush`` barrier), and the
server (plus its scheduler thread) must shut down cleanly.

Run: ``python -m crdt_graph_tpu_torch.scripts.serve_smoke [docs]
[writers] [deltas] [--device cpu]``

``--fleet N`` runs the FLEET smoke instead: N in-process fleet servers
(``cluster/gateway.py`` ``FleetServer``) over one shared MemoryKV, one
write entering through EACH server (forwarded to the document's ring
primary), then — after anti-entropy — read-your-writes verified through
a *different* server than the one that took the write, with the
replica-identity headers (``X-Replica-Id``/``-Name``/``-Epoch``,
``X-State-Fingerprint``) and the ``crdt_cluster_*`` prom families
checked on every member.  ``--fleet-procs N`` runs N server processes
on one host-shared body cache (each holds its own context on the card);
``--mergetier`` the merge-tier wire contract.  Each summary carries the
device block and the flight-audit samples of the run.
"""
import json
import os
import sys
import threading
import time

from . import _headline


def run(n_docs: int = 4, writers_per_doc: int = 3, deltas: int = 4,
        delta_size: int = 12, device=None) -> dict:
    from http.client import RemoteDisconnected

    from .. import engine as engine_mod
    from ..cluster.pool import ConnectionPool
    from ..codec import json_codec
    from ..core.operation import Add, Batch
    from ..service import make_server

    dev = _headline.resolve(device)
    audit0 = _headline.audit_mark()
    srv = make_server(port=0, device=dev)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_port

    # pooled keep-alive client connections (cluster/pool.py):
    # one link per client thread, reused request after request.  The
    # pre-pool smoke opened a fresh connection per request from ~16
    # unthrottled threads, and that loopback TIME_WAIT churn
    # occasionally landed a connect on a 4-tuple the kernel RSTs — the
    # flake the single transport retry below papered over.  With the
    # pool the flake is fixed by construction, so a CLEAN run now
    # ASSERTS both halves at the end: reuses ≫ opens (persistent
    # connections actually carried the run) and zero genuine retries.
    pool = ConnectionPool()
    transport_retries = [0]

    def req_full(method, path, body=None, headers=None):
        # the retry STAYS as a safety net (retrying POST /ops is safe
        # by construction: timestamps are writer-unique, so a delta
        # that DID land before a reset dup-absorbs on replay) — but a
        # clean run must never need it, which the caller asserts
        for attempt in (0, 1):
            src = threading.current_thread().name
            try:
                resp, raw = pool.request(
                    src, "server", "127.0.0.1", port, method, path,
                    body=body, headers=headers, timeout=60)
                resp.retried = bool(attempt)
                return resp.status, raw, resp
            except (ConnectionResetError, ConnectionAbortedError,
                    BrokenPipeError, RemoteDisconnected):
                if attempt:
                    raise
                transport_retries[0] += 1
                time.sleep(0.05)

    def req(method, path, body=None, headers=None):
        st, raw, _ = req_full(method, path, body=body, headers=headers)
        return st, raw

    doc_ids = [f"smoke{i}" for i in range(n_docs)]
    errors = []
    stop_readers = threading.Event()
    pushed_trace_ids = set()
    trace_lock = threading.Lock()

    def writer(doc_id):
        st, raw = req("POST", f"/docs/{doc_id}/replicas")
        if st != 200:
            errors.append(f"replicas {st}")
            return
        rid = json.loads(raw)["replica"]
        sess = f"smoke-sess-{doc_id}-r{rid}"
        prev, counter = 0, 0
        own_values = []
        for di in range(deltas):
            ops = []
            for _ in range(delta_size):
                counter += 1
                ts = rid * 2**32 + counter
                # per-writer-unique values so the read-your-writes
                # check below is not vacuous
                val = f"{rid}:{counter}"
                own_values.append(val)
                ops.append(Add(ts, (prev,), val))
                prev = ts
            # admission tracing: a client-supplied trace id
            # must come back in the response AND land on the commit's
            # flight record (checked against /debug/flight below)
            tid = f"smoke-{doc_id}-r{rid}-{di:02d}"
            with trace_lock:
                pushed_trace_ids.add(tid)
            st, raw, resp = req_full(
                "POST", f"/docs/{doc_id}/ops",
                json_codec.dumps(Batch(tuple(ops))),
                headers={"X-Trace-Id": tid, "X-Session-Id": sess})
            out = json.loads(raw)
            # applied_count 0 is legal ONLY when the transport retry
            # replayed a delta that already landed (timestamps are
            # writer-unique, so the dup absorbs); on a first attempt
            # any count but delta_size is a real loss
            count_ok = out.get("applied_count") == delta_size \
                or (resp.retried and out.get("applied_count") == 0)
            if st != 200 or not out.get("accepted") \
                    or not count_ok or out.get("trace_id") != tid:
                errors.append(f"push {st}: {out}")
                return
        # read-your-writes over the wire: every delta above
        # was acked AFTER its commit's snapshot published, so this
        # read MUST reflect all of them — and the new correlation
        # headers identify exactly which snapshot answered
        st, raw, resp = req_full("GET", f"/docs/{doc_id}",
                                 headers={"X-Session-Id": sess})
        if st != 200:
            errors.append(f"ryw read -> {st}")
            return
        served = set(json.loads(raw)["values"])
        missing_vals = [v for v in own_values if v not in served]
        if missing_vals:
            errors.append(
                f"{doc_id} r{rid}: read missed own acked writes "
                f"{missing_vals[:3]}")
        seq_hdr = resp.getheader("X-Commit-Seq")
        if seq_hdr is None or not resp.getheader(
                "X-Snapshot-Fingerprint"):
            errors.append(f"{doc_id} r{rid}: missing read trace headers")
        elif resp.getheader("X-Session-Id") != sess:
            errors.append(f"{doc_id} r{rid}: session id not adopted")

    def reader(doc_id):
        while not stop_readers.is_set():
            for sub in ("", "/ops?since=0", "/clock", "/metrics"):
                st, _ = req("GET", f"/docs/{doc_id}{sub}")
                if st != 200:
                    errors.append(f"read {sub} -> {st}")
                    return
            # the scrape surface must hold up under live traffic too
            st, _ = req("GET", "/metrics/prom")
            if st != 200:
                errors.append(f"read /metrics/prom -> {st}")
                return

    writers = [threading.Thread(target=writer, args=(d,), daemon=True)
               for d in doc_ids for _ in range(writers_per_doc)]
    readers = [threading.Thread(target=reader, args=(d,), daemon=True)
               for d in doc_ids]
    for t in writers:
        t.start()
    # readers 404 until the writers' POST /replicas has materialized
    # every document — wait for creation (a startup race, not a serving
    # property; on a loaded box the first reader can outrun the first
    # writer's request)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        st, raw = req("GET", "/docs")
        if st == 200 and set(doc_ids) <= set(json.loads(raw)["docs"]):
            break
        time.sleep(0.01)
    else:
        errors.append("documents never materialized")
    for t in readers:
        t.start()
    for t in writers:
        t.join(120)
    stop_readers.set()
    for t in readers:
        t.join(30)
    assert not errors, errors[:5]

    # convergence: each doc's full op replay equals its served values
    expected_ops = writers_per_doc * deltas * delta_size
    summary = {}
    for d in doc_ids:
        st, raw = req("GET", f"/docs/{d}/ops?since=0")
        assert st == 200
        replica = engine_mod.init(0, device=dev)
        replica.apply(json_codec.loads(raw))
        st, raw = req("GET", f"/docs/{d}")
        served = json.loads(raw)["values"]
        assert replica.visible_values() == served, f"{d} diverged"
        assert len(served) == expected_ops, \
            f"{d}: {len(served)} visible, want {expected_ops}"
        st, raw = req("GET", f"/docs/{d}/metrics")
        m = json.loads(raw)
        assert m["ops_merged"] == expected_ops, m
        summary[d] = {"visible": len(served),
                      "coalesce_p50": m["coalesce_width"].get("p50")}

    st, raw = req("GET", "/metrics/scheduler")
    assert st == 200
    summary["scheduler"] = json.loads(raw)

    # unified telemetry exposition: /metrics/prom parses
    # under the strict naming contract (crdt_ namespace, counters end
    # _total, cumulative le buckets) and accounts for every document
    from ..obs import prom as prom_mod
    st, raw = req("GET", "/metrics/prom")
    assert st == 200, st
    fams = prom_mod.parse_text(raw.decode())
    for family in ("crdt_doc_ops_merged_total",
                   "crdt_doc_commit_latency_ms", "crdt_span_ms_total",
                   "crdt_flight_records_total"):
        assert family in fams, f"missing prom family {family}"
    merged_by_doc = {lbl["doc"]: v for _, lbl, v in
                     fams["crdt_doc_ops_merged_total"]["samples"]}
    for d in doc_ids:
        assert merged_by_doc.get(d) == expected_ops, \
            f"{d}: prom says {merged_by_doc.get(d)}"

    # flight recorder: every commit record carries ≥1 trace id, and the
    # records' union covers every id the pushes carried.  Records land
    # ASYNCHRONOUSLY after the ticket resolves (the scheduler appends
    # them after done.set()) — the flush barrier (ServingEngine.flush)
    # joins the scheduler up to this point WITHOUT closing it, so one scrape suffices where a records_total poll used to.
    assert srv.store.flush(timeout=30), "scheduler flush timed out"
    st, raw = req("GET", "/debug/flight")
    assert st == 200, st
    flight = json.loads(raw)
    seen_ids = set()
    for r in flight["records"]:
        seen_ids.update(r["trace_ids"])
    assert flight["records"], "no flight records"
    for r in flight["records"]:
        assert r["trace_ids"], f"flight record {r['seq']} untraced"
    missing = pushed_trace_ids - seen_ids
    # the bounded ring may have evicted the oldest commits at scale;
    # at smoke scale (records_total under capacity) nothing may be lost
    if flight["records_total"] <= flight["capacity"]:
        assert not missing, f"untracked pushes: {sorted(missing)[:5]}"
    summary["flight"] = {"records_total": flight["records_total"],
                         "trace_ids_seen": len(seen_ids)}

    # watch fan-out: park watchers on the publish pointer,
    # push ONE delta, and prove the whole population was served from
    # ONE cached encode — byte-identical bodies, and the readcache
    # counters pin exactly one miss (the encode) per generation with
    # every other delivery a hit
    wdoc = doc_ids[0]
    st, raw, resp = req_full(
        "GET", f"/docs/{wdoc}/ops?since=0&limit=100000")
    assert st == 200
    mark = int(resp.getheader("X-Since-Next"))
    wd = srv.store.get(wdoc, create=False)
    rc0 = wd.readcache.snapshot()
    n_watch = 24
    wresults = {}

    def watch_leg(k):
        st, raw, resp = req_full(
            "GET",
            f"/docs/{wdoc}/watch?since={mark}&limit=100000&timeout=30")
        wresults[k] = (st, raw, resp.getheader("X-Watch-Event"))

    thr0 = threading.active_count()
    wthreads = [threading.Thread(target=watch_leg, args=(k,),
                                 daemon=True, name=f"smoke-watch-{k}")
                for k in range(n_watch)]
    for t in wthreads:
        t.start()
    deadline = time.monotonic() + 30
    while wd.watch.counts()["parked"] < n_watch:
        assert time.monotonic() < deadline, "watchers never parked"
        time.sleep(0.005)
    # reactor egress: with the selector tier on, a parked
    # watcher holds NO handler thread — the process grew by the
    # n_watch CLIENT threads above plus at most the reactor's loop
    # threads, so parked count ≫ server-side thread delta
    reactor = getattr(srv.store, "reactor", None)
    if reactor is not None:
        server_thread_delta = threading.active_count() - thr0 - n_watch
        assert server_thread_delta <= 6, \
            (server_thread_delta, n_watch, threading.active_count())
        rsnap = reactor.snapshot()
        assert rsnap["parked"] == n_watch, rsnap
        assert rsnap["threads"] <= 4, rsnap
        summary["reactor"] = {
            "parked": rsnap["parked"],
            "loop_threads": rsnap["threads"],
            "server_thread_delta": server_thread_delta}
    st, raw = req("POST", f"/docs/{wdoc}/replicas")
    wrid = json.loads(raw)["replica"]
    st, raw = req("POST", f"/docs/{wdoc}/ops",
                  json_codec.dumps(Batch(
                      (Add(wrid * 2**32 + 1, (0,), "watched"),))))
    assert st == 200 and json.loads(raw)["accepted"], raw
    for t in wthreads:
        t.join(60)
    assert len(wresults) == n_watch, wresults
    assert all(r[0] == 200 for r in wresults.values()), wresults
    assert all(r[2] == "notify" for r in wresults.values()), wresults
    assert len({r[1] for r in wresults.values()}) == 1, \
        "watchers saw different bodies for one generation"
    rc1 = wd.readcache.snapshot()
    # two generations touched the shared window key (the pre-park
    # caught-up check, then the delivery) — one encode each, every
    # other watcher a cache hit
    assert rc1["misses"] - rc0["misses"] == 2, (rc0, rc1)
    assert rc1["hits"] - rc0["hits"] == 2 * (n_watch - 1), (rc0, rc1)
    deadline = time.monotonic() + 10
    while wd.watch.counts()["registered"]:
        assert time.monotonic() < deadline, \
            "watch registry never drained"
        time.sleep(0.005)
    st, raw = req("GET", "/metrics/prom")
    assert st == 200
    fams = prom_mod.parse_text(raw.decode())
    assert "crdt_watch_notifies_total" in fams
    assert "crdt_watch_notify_ms" in fams
    notified = sum(v for _, lbl, v in
                   fams["crdt_watch_notifies_total"]["samples"]
                   if lbl["doc"] == wdoc)
    assert notified >= n_watch, fams["crdt_watch_notifies_total"]
    summary["watch"] = {
        "watchers": n_watch,
        "readcache_misses_delta": rc1["misses"] - rc0["misses"],
        "readcache_hits_delta": rc1["hits"] - rc0["hits"]}

    # pooled-connection contract: persistent connections
    # actually carried the run (reuses ≫ opens — each client thread
    # issues many requests over its one pooled link), and the
    # TIME_WAIT flake is fixed by construction — no genuine transport
    # retry fired, and no stale-reuse retry was needed either
    ps = pool.stats()
    assert ps["reuses"] > ps["opens"], \
        f"pooled connections not reused: {ps}"
    assert transport_retries[0] == 0, \
        f"{transport_retries[0]} transport retries in a clean run " \
        f"(pool: {ps})"
    summary["connpool"] = ps
    summary["transport_retries"] = transport_retries[0]
    pool.close()

    # clean shutdown: server AND scheduler thread stop
    engine = srv.store
    srv.shutdown()
    srv.server_close()
    assert not engine.scheduler.is_alive(), "scheduler survived shutdown"
    assert engine.scheduler.stopped
    summary["device"] = _headline.device_block(dev)
    summary["flight_audit"] = _headline.audit_since(audit0)
    return summary


def run_fleet(n_servers: int = 3, n_docs: int = 2, device=None) -> dict:
    """The fleet smoke: one write per server, read-your-writes through
    a DIFFERENT server after anti-entropy, honest replica headers and
    the cluster scrape surface on every member, clean shutdown."""
    from http.client import HTTPConnection

    from ..cluster import FleetServer, MemoryKV
    from ..codec import json_codec
    from ..core.operation import Add, Batch
    from ..obs import prom as prom_mod

    assert n_servers >= 2, "a fleet needs at least two servers"
    dev = _headline.resolve(device)
    audit0 = _headline.audit_mark()
    kv = MemoryKV()
    fleet = [FleetServer(f"n{i}", kv, ttl_s=600.0,
                         ae_interval_s=3600.0, device=dev)
             for i in range(n_servers)]
    # membership settled before traffic: every node joined above, so
    # one explicit refresh gives every ring the full fleet
    for fs in fleet:
        assert len(fs.node.refresh_ring()) == n_servers

    def req(fs, method, path, body=None, headers=None):
        conn = HTTPConnection("127.0.0.1", fs.port, timeout=60)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, resp.read(), dict(resp.getheaders())
        finally:
            conn.close()

    summary = {"servers": n_servers, "docs": n_docs, "writes": 0,
               "forwarded": 0, "cross_server_ryw": 0}
    try:
        doc_ids = [f"fleet{i}" for i in range(n_docs)]
        own = {}       # (doc, writer server) -> values it got acked
        for doc in doc_ids:
            for i, fs in enumerate(fleet):
                # one write per server on each doc, each through ITS
                # entry — non-primaries forward to the ring primary
                st, raw, _ = req(fs, "POST", f"/docs/{doc}/replicas")
                assert st == 200, (doc, fs.name, raw)
                rid = json.loads(raw)["replica"]
                ops, prev = [], 0
                vals = []
                for c in range(1, 6):
                    t = rid * 2**32 + c
                    vals.append(f"{doc}@{fs.name}:{c}")
                    ops.append(Add(t, (prev,), vals[-1]))
                    prev = t
                st, raw, _ = req(
                    fs, "POST", f"/docs/{doc}/ops",
                    body=json_codec.dumps(Batch(tuple(ops))),
                    headers={"X-Trace-Id":
                             f"fleet-smoke-{doc}-{fs.name}"})
                out = json.loads(raw)
                assert st == 200 and out["accepted"], (doc, fs.name, out)
                assert "served_by" in out, "fleet ack must attribute"
                summary["writes"] += 1
                if out["served_by"]["name"] != fs.name:
                    summary["forwarded"] += 1
                own[(doc, i)] = vals
        # anti-entropy: one driven round per node converges the fleet
        for fs in fleet:
            fs.node.antientropy.sync_now()
        for doc in doc_ids:
            fps = set()
            for i, fs in enumerate(fleet):
                # read-your-writes through a DIFFERENT server than the
                # one that took this writer's delta
                other = fleet[(i + 1) % n_servers]
                st, raw, hdr = req(other, "GET", f"/docs/{doc}")
                assert st == 200, (doc, other.name)
                served = set(json.loads(raw)["values"])
                missing = [v for v in own[(doc, i)] if v not in served]
                assert not missing, (doc, fs.name, "via", other.name,
                                     missing)
                summary["cross_server_ryw"] += 1
                for h in ("X-Replica-Id", "X-Replica-Name",
                          "X-Replica-Epoch", "X-State-Fingerprint",
                          "X-Commit-Seq", "X-Snapshot-Fingerprint"):
                    assert h in hdr, (other.name, h)
                assert hdr["X-Replica-Name"] == other.name
                fps.add(hdr["X-State-Fingerprint"])
            assert len(fps) == 1, (doc, "fleet diverged", fps)
            summary[doc] = {"visible": len(served),
                            "state_fingerprint": fps.pop()}
        # every member's scrape surface holds, cluster families included
        for fs in fleet:
            st, raw, _ = req(fs, "GET", "/metrics/prom")
            assert st == 200
            fams = prom_mod.parse_text(raw.decode())
            assert "crdt_cluster_members" in fams
            assert "crdt_cluster_antientropy_sync_age_seconds" in fams
            st, raw, _ = req(fs, "GET", "/cluster")
            assert st == 200
            assert len(json.loads(raw)["members"]) == n_servers
    finally:
        for fs in fleet:
            fs.stop()
    for fs in fleet:
        assert not fs.node.engine.scheduler.is_alive(), \
            f"{fs.name}: scheduler survived shutdown"
    assert summary["forwarded"] > 0, "no write exercised forwarding"
    summary["device"] = _headline.device_block(dev)
    summary["flight_audit"] = _headline.audit_since(audit0)
    return summary


def _fleet_proc_worker() -> None:
    """One member of the ``--fleet-procs`` smoke (child process;
    internal entry point).  Applies the SAME deterministic workload as
    every sibling — converged state ⇒ identical fingerprints ⇒ the
    host-shared segment names agree without coordination — reading the
    whole-doc body once per generation, with a marker-file barrier so
    no member retires generation g before every member has claimed it
    (that is what makes the miss/hit ledger exact, not statistical)."""
    from ..codec import json_codec
    from ..core.operation import Add, Batch
    from ..serve import ServingEngine

    bdir = os.environ["SMOKE_BARRIER_DIR"]
    n_procs = int(os.environ["SMOKE_PROCS"])
    gens = int(os.environ["SMOKE_GENS"])
    eng = ServingEngine(oplog_hot_ops=8, shmcache=True,
                        device=os.environ["SMOKE_DEVICE"])
    assert eng.shmcache is not None, "shm tier failed to arm"
    fps = []
    anchor, counter = 0, 0
    for g in range(gens):
        ops = []
        for _ in range(6):
            counter += 1
            t = (1 << 32) + counter
            ops.append(Add(t, (anchor,), counter & 0xFF))
            anchor = t
        ok, _ = eng.submit("smoke", json_codec.dumps(Batch(tuple(ops))))
        assert ok, f"gen {g} rejected"
        snap = eng.get("smoke").read_view()
        bytes(snap.values_body())
        assert snap.shm_seg_name is not None, f"gen {g} not shared"
        fps.append(snap.state_fingerprint())
        # barrier: claim logged, wait for the whole fleet before any
        # member's next publish can retire this generation
        with open(os.path.join(bdir, f"g{g}.{os.getpid()}"), "w"):
            pass
        deadline = time.time() + 60
        while sum(1 for f in os.listdir(bdir)
                  if f.startswith(f"g{g}.")) < n_procs:
            if time.time() > deadline:
                raise SystemExit(f"barrier timeout at gen {g}")
            time.sleep(0.02)
    stats = eng.shmcache.stats.snapshot()
    eng.close()
    print(json.dumps({"stats": stats, "fps": fps}), flush=True)


def run_fleet_procs(n_procs: int = 3, gens: int = 4,
                    device=None) -> dict:
    """The cross-PROCESS shared-memory smoke (docs/SERVING.md
    §Shared-memory body cache): N real OS processes converge on the
    same document and serve its encoded body out of ONE shm segment
    per generation.  Exact ledger, asserted per generation across the
    fleet: misses +1 (one encode on the whole host), hits +(N-1)
    (everyone else attaches), zero degradations, identical
    fingerprints, and zero leaked segments after every member exits.
    Each member is a ``python -m`` child that merges on ``device``
    (the card: one context a process)."""
    import shutil
    import subprocess
    import tempfile
    import uuid

    assert n_procs >= 3, "the contract needs at least three processes"
    dev = _headline.resolve(device)
    ns = f"smoke{uuid.uuid4().hex[:10]}"
    bdir = tempfile.mkdtemp(prefix="graft-shm-smoke-")
    env = dict(os.environ)
    env.update({"GRAFT_SHMCACHE_NS": ns, "SMOKE_BARRIER_DIR": bdir,
                "SMOKE_PROCS": str(n_procs), "SMOKE_GENS": str(gens),
                "SMOKE_DEVICE": str(dev),
                # the children import this checkout's package
                "PYTHONPATH": os.pathsep.join(
                    [str(_headline.ROOT)]
                    + [p for p in [os.environ.get("PYTHONPATH")] if p])})
    procs = [subprocess.Popen(
        [sys.executable, "-m", __spec__.name, "--fleet-proc-worker"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for _ in range(n_procs)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=180)
            assert p.returncode == 0, \
                f"worker died rc={p.returncode}: {stderr[-2000:]}"
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(bdir, ignore_errors=True)
    # converged: every member saw the identical generation chain
    for got in outs[1:]:
        assert got["fps"] == outs[0]["fps"], "fleet diverged"
    # the exact ledger: gens encodes on the host, everything else
    # attached, nobody fell back to the process-local path
    misses = sum(o["stats"]["misses"] for o in outs)
    hits = sum(o["stats"]["hits"] for o in outs)
    failed = sum(o["stats"]["attach_failed"] for o in outs)
    assert misses == gens, (misses, gens)
    assert hits == gens * (n_procs - 1), (hits, gens, n_procs)
    assert failed == 0, f"{failed} degraded attaches"
    # every worker pulled its weight (each gen: one miss XOR one hit)
    for o in outs:
        st = o["stats"]
        assert st["misses"] + st["hits"] == gens, st
    # nothing leaked past the last exit (manifest file aside)
    leaked = [f for f in os.listdir("/dev/shm")
              if ns in f and not f.endswith(".manifest")] \
        if os.path.isdir("/dev/shm") else []
    assert not leaked, f"leaked shm segments: {leaked}"
    try:
        os.unlink(os.path.join("/dev/shm", f"graftshm-{ns}.manifest"))
    except OSError:
        pass
    return {"procs": n_procs, "gens": gens, "misses": misses,
            "hits": hits, "shared_bytes": sum(
                o["stats"]["shared_bytes"] for o in outs),
            "device": _headline.device_block(dev)}


def run_mergetier(n_docs: int = 3, n_ops: int = 1200,
                  device=None) -> dict:
    """Merge-tier wire-contract smoke (docs/MERGETIER.md; wired into
    tier-1 via tests/test_serve_smoke.py::test_mergetier_smoke):

    one merge worker behind a REAL ``POST /merge`` HTTP surface, one
    front-end engine armed with the tier, one local-only control.
    ``n_docs`` coalescible deltas land through the front-end's real
    ``/docs/{id}/ops`` surface in one staged round, so the round ships
    to the worker, coalesces in its linger window, and comes back as
    ONE batched launch — then every document's values, clock, and
    replica-independent state fingerprint must equal the control's,
    the client must report zero fallbacks, and BOTH prom scrapes
    (front-end ``crdt_mergetier_*``, worker
    ``crdt_mergetier_worker_*`` with the linger occupancy gauge) must
    strict-parse over HTTP.  Clean shutdown on every piece."""
    from ..cluster.pool import ConnectionPool
    from ..codec import json_codec
    from ..core.operation import Add, Batch
    from ..mergetier.client import MergeTierClient
    from ..mergetier.worker import MergeWorker, MergeWorkerServer
    from ..obs import prom as prom_mod
    from ..serve import ServingEngine
    from ..service import make_server

    dev = _headline.resolve(device)
    audit0 = _headline.audit_mark()

    def chain_body(rid, n):
        ops, prev = [], 0
        for i in range(n):
            ts = rid * 2**32 + i + 1
            ops.append(Add(ts, (prev,), f"{rid}:{i}"))
            prev = ts
        return json_codec.dumps(Batch(tuple(ops)))

    # a deliberately wide linger window: the smoke asserts the EXACT
    # coalesced width, so encode/HTTP skew between the three requests
    # must not split the epoch (production tunes GRAFT_MERGETIER_BATCH_MS
    # against fleet arrival rates instead)
    worker_srv = MergeWorkerServer(MergeWorker(linger_ms=150.0,
                                               device=dev))
    engine = ServingEngine(start=False, cross_doc=True, device=dev,
                           mergetier=MergeTierClient([worker_srv.addr],
                                                     src="smoke-fe"))
    assert engine.mergetier is not None, "tier did not arm"
    srv = make_server(port=0, store=engine)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_port
    control = ServingEngine(start=True, cross_doc=True, device=dev)
    pool = ConnectionPool()
    doc_ids = [f"mt{i}" for i in range(n_docs)]
    bodies = {d: chain_body(i + 2, n_ops)
              for i, d in enumerate(doc_ids)}
    results = {}

    def post(doc_id):
        resp, raw = pool.request(
            "smoke-mt", "server", "127.0.0.1", port, "POST",
            f"/docs/{doc_id}/ops", body=bodies[doc_id],
            headers={"Content-Type": "application/json"}, timeout=180)
        results[doc_id] = (resp.status, json.loads(raw))

    threads = [threading.Thread(target=post, args=(d,), daemon=True)
               for d in doc_ids]
    for t in threads:
        t.start()
    # every delta staged before the ONE scheduling round: the round is
    # what the tier coalesces, so arrival skew must not split it
    deadline = time.monotonic() + 30
    for d in doc_ids:
        while len(engine.get(d).queue) < 1:
            assert time.monotonic() < deadline, "staging stalled"
            time.sleep(0.002)
    assert engine.scheduler.step() == n_docs
    for t in threads:
        t.join(120)
    for d, (st, out) in results.items():
        assert st == 200, f"{d}: POST /ops answered {st}"
        assert out["applied_count"] == n_ops, f"{d}: {out}"
        control.submit(d, bodies[d])

    # remote-vs-local convergence at the wire: values, clock, and the
    # replica-independent fingerprint all match the local-only control
    for d in doc_ids:
        sv, cv = engine.get(d).snapshot_view(), \
            control.get(d).snapshot_view()
        assert engine.get(d).snapshot() == control.get(d).snapshot(), d
        assert engine.get(d).clock() == control.get(d).clock(), d
        assert sv.state_fingerprint() == cv.state_fingerprint(), d
    mst = engine.mergetier.stats()
    assert mst["remote_docs"] == n_docs, mst
    assert not mst["fallbacks"], mst
    wst = worker_srv.worker.stats()
    assert wst["batch_width"]["max"] == n_docs, wst

    # both prom surfaces strict-parse over HTTP, tier families present
    resp, raw = pool.request("smoke-mt", "server", "127.0.0.1", port,
                             "GET", "/metrics/prom", timeout=60)
    assert resp.status == 200
    fams = prom_mod.parse_text(raw.decode())
    assert "crdt_mergetier_rounds_total" in fams
    assert "crdt_mergetier_batch_width" in fams
    resp, raw = pool.request("smoke-mt", "worker", "127.0.0.1",
                             worker_srv.port, "GET", "/metrics/prom",
                             timeout=60)
    assert resp.status == 200
    wfams = prom_mod.parse_text(raw.decode())
    assert "crdt_mergetier_worker_launches_total" in wfams
    assert "crdt_mergetier_worker_linger_occupancy" in wfams

    pool.close()
    srv.shutdown()
    srv.server_close()
    engine.close()
    control.close()
    worker_srv.stop()
    return {"harness": "serve_smoke_mergetier", "docs": n_docs,
            "ops_per_doc": n_ops, "remote_docs": mst["remote_docs"],
            "batch_width_max": wst["batch_width"]["max"],
            "launches": wst["batcher"]["launches"],
            "fallbacks": mst["fallbacks"],
            "device": _headline.device_block(dev),
            "flight_audit": _headline.audit_since(audit0)}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--fleet-proc-worker" in argv:
        _fleet_proc_worker()
        return 0
    device, argv = _headline.split_device(argv)
    if "--fleet-procs" in argv:
        i = argv.index("--fleet-procs")
        n = int(argv[i + 1]) if len(argv) > i + 1 else 3
        out = run_fleet_procs(n_procs=n, device=device)
    elif "--fleet" in argv:
        i = argv.index("--fleet")
        n = int(argv[i + 1]) if len(argv) > i + 1 else 3
        out = run_fleet(n_servers=n, device=device)
    elif "--mergetier" in argv:
        out = run_mergetier(device=device)
    else:
        out = run(*(int(a) for a in argv[:3]), device=device)
    print(json.dumps(out), flush=True)
    print("serve_smoke OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
