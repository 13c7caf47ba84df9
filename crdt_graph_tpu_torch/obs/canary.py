"""The canary prober: continuous black-box write-to-global-visibility
measurement (docs/OBSERVABILITY.md §Fleet tracing & visibility ledger).

Every ``GRAFT_CANARY_INTERVAL_S`` the prober pushes one tiny
self-identifying delta through the REAL admission path (parse →
ticket → scheduler fuse → WAL → publish — the same pipeline client
writes ride) on a dedicated per-node canary document
(``__canary__<node>``), then confirms the write became visible:

- **ack** — ``apply_body`` returned (publish happened at this node);
- **watch** — the document's own watch registry resolved past the new
  generation (the delta-push visibility edge);
- **peer** — every live fleet member serves a read whose
  ``X-State-Fingerprint`` matches the writer's post-probe state, over
  the SAME pooled + netchaos-wrapped links real traffic uses — so an
  injected 250 ms delay link shows up in the canary's numbers, which
  is the point.

The result is the ``crdt_canary_*`` prom families (e2e visibility
histogram, per-stage breakdown, probes/failures by hop) rendered by
``obs/prom.py render_cluster`` — continuous, synthetic, and end to
end, where the visibility ledger (obs/ledger.py) is passive and
per-commit.  A stage exceeding ``GRAFT_CANARY_SLO_MS`` fires a flight
dump (reason ``canary`` — rate-limited by the recorder itself, so a
flapping link cannot spam disk).

Default ON for fleet nodes (``ClusterNode.start`` arms it;
``GRAFT_CANARY=0`` disables, interval <= 0 likewise).  The first probe
fires only after one full interval, so short-lived test fleets under
the 30 s default never see one.
"""
from __future__ import annotations

import os
import threading
import time
from http.client import HTTPException
from typing import Dict, Optional

from ..serve.metrics import Histogram
from ..utils.hostenv import env_float as _env_float

DEFAULT_INTERVAL_S = 30.0
DEFAULT_SLO_MS = 5_000.0
DEFAULT_PEER_TIMEOUT_S = 10.0

# canary writes use a reserved replica id far above the KV counter's
# practical range; only this node ever writes its own canary doc, so
# timestamps stay unique by construction
CANARY_RID = 0x3FFF_FFFF

# e2e + per-stage visibility in seconds (same scale as the ledger)
CANARY_BOUNDS_S = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def enabled() -> bool:
    """``GRAFT_CANARY`` (default ON; ``=0`` disables the prober)."""
    return os.environ.get("GRAFT_CANARY", "1").strip() not in ("", "0")


class CanaryProber:
    """One per fleet node; owns a daemon thread.  All state is
    lock-guarded — probe results are read by the prom scrape and
    ``cluster_stats`` while a probe is in flight."""

    def __init__(self, node, interval_s: Optional[float] = None,
                 slo_ms: Optional[float] = None,
                 peer_timeout_s: Optional[float] = None):
        self.node = node
        self.doc_id = f"__canary__{node.name}"
        if interval_s is None:
            interval_s = _env_float("GRAFT_CANARY_INTERVAL_S",
                                    DEFAULT_INTERVAL_S)
        if slo_ms is None:
            slo_ms = _env_float("GRAFT_CANARY_SLO_MS", DEFAULT_SLO_MS)
        if peer_timeout_s is None:
            peer_timeout_s = _env_float("GRAFT_CANARY_PEER_TIMEOUT_S",
                                        DEFAULT_PEER_TIMEOUT_S)
        self.interval_s = interval_s
        self.slo_ms = slo_ms
        self.peer_timeout_s = peer_timeout_s
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._n = 0
        self._prev_ts = 0
        self.probes = 0
        self.failures: Dict[str, int] = {}
        self.slo_breaches = 0
        self.e2e_s = Histogram(CANARY_BOUNDS_S)
        self.stage_s: Dict[str, Histogram] = {}
        self.last_probe: Optional[Dict] = None

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "CanaryProber":
        if self._thread is None and self.interval_s > 0:
            self._thread = threading.Thread(
                target=self._run, name=f"canary-{self.node.name}",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(10)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.probe()
            except Exception as e:   # noqa: BLE001 — the prober must
                # never die with the fleet still up; a failed probe is
                # a counted failure, not a crashed thread
                self._fail("probe", repr(e))

    # -- one probe --------------------------------------------------------

    def _fail(self, hop: str, detail: Optional[str] = None) -> None:
        with self._lock:
            self.failures[hop] = self.failures.get(hop, 0) + 1
            if detail and self.last_probe is not None:
                self.last_probe.setdefault("errors", []).append(
                    f"{hop}: {detail}"[:200])

    def _observe_stage(self, stage: str, seconds: float) -> None:
        with self._lock:
            h = self.stage_s.get(stage)
            if h is None:
                h = self.stage_s[stage] = Histogram(CANARY_BOUNDS_S)
            h.observe(seconds)

    def probe(self) -> Dict:
        """One synthetic write + full visibility confirmation.  Returns
        the probe record (also kept as ``last_probe``)."""
        from ..codec import json_codec
        from ..core.operation import Add, Batch
        node = self.node
        with self._lock:
            self._n += 1
            n = self._n
            prev = self._prev_ts
            self.probes += 1
            self.last_probe = {"n": n, "stages_s": {}, "ok": False}
        tid = f"canary-{node.name}-{n:08d}"
        can_ts = CANARY_RID * 2**32 + n
        body = json_codec.dumps(Batch((
            Add(can_ts, (prev,), f"canary:{node.name}:{n}"),)))
        doc = node.get(self.doc_id)
        seq_before = doc.snapshot_view().seq
        t0 = time.perf_counter()
        stages: Dict[str, float] = {}
        ft = getattr(node, "fleettrace", None)

        # hop 1: the real admission path, under our own trace id
        try:
            accepted, _ = doc.apply_body(body, trace_id=tid)
        except Exception as e:   # noqa: BLE001 — 429/503 included:
            # an unavailable admission path IS the canary's finding
            self._fail("write", repr(e))
            return self._finish(tid, t0, stages, ok=False)
        if not accepted:
            self._fail("write", "rejected")
            return self._finish(tid, t0, stages, ok=False)
        with self._lock:
            self._prev_ts = can_ts
        stages["ack"] = time.perf_counter() - t0
        snap = doc.snapshot_view()
        fp = snap.state_fingerprint()

        # hop 2: our own watch stream sees the generation
        kind, _published = doc.watch.wait_beyond(
            seq_before, timeout=min(self.peer_timeout_s, 10.0))
        if kind == "new":
            stages["watch"] = time.perf_counter() - t0
            if ft is not None:
                ft.record(tid, "canary", stage="watch",
                          ms=round(stages["watch"] * 1e3, 3))
        else:
            self._fail("watch", kind)

        # hop 3: every live peer serves our state, over pooled +
        # chaos-wrapped links (the links real traffic rides)
        members = {name: ls for name, ls in node.members().items()
                   if name != node.name}
        pending = dict(members)
        deadline = time.perf_counter() + self.peer_timeout_s
        while pending and not self._stop.is_set() \
                and time.perf_counter() < deadline:
            for name in list(pending):
                ls = pending[name]
                host, port = ls.addr.rsplit(":", 1)
                try:
                    resp, _body = node.pool.request(
                        node.name, name, host, int(port), "GET",
                        f"/docs/{self.doc_id}",
                        timeout=min(5.0, self.peer_timeout_s))
                except (OSError, HTTPException):
                    continue
                if resp.status == 200 and resp.getheader(
                        "X-State-Fingerprint") == fp:
                    lag = time.perf_counter() - t0
                    stages.setdefault("peer_first", lag)
                    stages[f"_peer:{name}"] = lag
                    if ft is not None:
                        ft.record(tid, "canary", stage="peer",
                                  peer=name,
                                  ms=round(lag * 1e3, 3))
                    del pending[name]
            if pending:
                time.sleep(0.05)
        for name in pending:
            self._fail(f"peer:{name}")
        if members and not pending:
            stages["peer_all"] = time.perf_counter() - t0
        return self._finish(tid, t0, stages, ok=not pending)

    def _finish(self, tid: str, t0: float, stages: Dict[str, float],
                ok: bool) -> Dict:
        e2e = time.perf_counter() - t0
        public = {k: round(v, 6) for k, v in stages.items()
                  if not k.startswith("_")}
        peers = {k[len("_peer:"):]: round(v, 6)
                 for k, v in stages.items() if k.startswith("_peer:")}
        for stage, v in public.items():
            self._observe_stage(stage, v)
        self.e2e_s.observe(e2e)
        breach = [s for s, v in stages.items()
                  if v * 1e3 > self.slo_ms]
        rec = {"trace_id": tid, "ok": ok, "e2e_s": round(e2e, 6),
               "stages_s": public, "peers_s": peers,
               "slo_breach": sorted(s.lstrip("_") for s in breach)}
        with self._lock:
            errors = (self.last_probe or {}).get("errors")
            if errors:
                rec["errors"] = errors
            self.last_probe = rec
            if breach:
                self.slo_breaches += 1
        if breach or not ok:
            # rate-limited by the recorder's per-reason dump interval
            try:
                self.node.engine.flight.dump("canary")
            except Exception:    # noqa: BLE001 — recorder boundary
                pass
        return rec

    # -- exposition -------------------------------------------------------

    def stats(self) -> Dict:
        with self._lock:
            failures = dict(self.failures)
            last = dict(self.last_probe) if self.last_probe else None
            stage_names = sorted(self.stage_s)
        return {"doc": self.doc_id,
                "interval_s": self.interval_s,
                "slo_ms": self.slo_ms,
                "probes": self.probes,
                "failures": failures,
                "slo_breaches": self.slo_breaches,
                "e2e": self.e2e_s.export(),
                "stages": {s: self.stage_s[s].export()
                           for s in stage_names},
                "last_probe": last}
