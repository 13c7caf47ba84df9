"""The fleet gateway: every server accepts every request.

:class:`ClusterNode` wraps one :class:`~crdt_graph_tpu_torch.serve.
ServingEngine` with the fleet surface the HTTP layer (service/http.py)
dispatches on:

- **Writes route to the primary.**  ``write_route`` resolves the
  document's owner on the consistent-hash ring over the LIVE lease
  table; a non-primary node relays the request verbatim
  (``forward_write``: bounded connection retries with ring re-resolution
  between attempts, upstream ``429``/``Retry-After`` passed straight
  through so backpressure keeps one semantic fleet-wide).  A request
  already carrying ``X-Fleet-Forwarded`` always applies locally — one
  hop maximum, no forwarding loops, and a write landing on a deposed
  primary is merely suboptimal, never wrong: the CRDT converges from
  any application site via anti-entropy (docs/CLUSTER.md §Failure
  matrix).
- **Reads are replica-local.**  Read endpoints resolve against this
  node's own published snapshot — never proxied — and
  ``extra_read_headers`` stamps the replica identity
  (``X-Replica-Id``/``-Name``/``-Epoch``) and the replica-independent
  ``X-State-Fingerprint`` next to the existing ``X-Commit-Seq``/
  ``X-Snapshot-Fingerprint``, so a client (or the session oracle)
  can SEE exactly how stale the answering replica is.
- **Replica ids are fleet-unique.**  ``POST /docs/{id}/replicas`` on
  any server allocates from the KV counter ``replica/{doc}``
  (kv.next_counter), so failover never re-issues an id.

:class:`FleetServer` bundles node + HTTP server + lifecycle for the
in-process fleets the tests and ``chip_smoke.py``'s fleet phase spin
up — including ``crash()``, which drops the node the way a
``kill -9`` would (no lease release, no graceful drain).
"""
from __future__ import annotations

import json
import threading
import time
from http.client import HTTPException
from typing import Dict, List, Optional, Tuple

from ..obs import canary as canary_mod
from ..obs import fleettrace as fleettrace_mod
from ..obs import flight as flight_mod
from ..obs import ledger as ledger_mod
from ..obs import prom as prom_mod
from ..obs.trace import (AE_LAG_HEADER, FORWARDED_HEADER,
                         REPLICA_EPOCH_HEADER,
                         REPLICA_HEADER, REPLICA_NAME_HEADER,
                         SESSION_HEADER, SINCE_FOUND_HEADER,
                         SINCE_MORE_HEADER, SINCE_NEXT_HEADER,
                         SPAN_CTX_HEADER, STATE_FP_HEADER,
                         TRACE_HEADER, ensure_trace_id)
from ..serve import ServingEngine
from ..utils.hostenv import env_float as _env_float
from . import kv as kv_mod
from . import netchaos as netchaos_mod
from . import pool as pool_mod
from .antientropy import AntiEntropy
from .lease import Lease, LeaseKeeper, LeaseService
from .ring import HashRing

# headers relayed verbatim from a forwarded write's upstream response
_RELAY_HEADERS = ("Content-Type", "Retry-After", TRACE_HEADER,
                  SESSION_HEADER, REPLICA_HEADER, REPLICA_NAME_HEADER,
                  REPLICA_EPOCH_HEADER)


class ForwardError(Exception):
    """The document's primary could not be reached within the retry
    budget.  The HTTP layer answers 503 + Retry-After — the client
    retries once the lease table has failed the primary over (≤ one
    TTL)."""

    def __init__(self, doc_id: str, detail: str,
                 retry_after_s: int = 1):
        super().__init__(f"primary for {doc_id!r} unreachable: "
                         f"{detail}; retry in ~{retry_after_s}s")
        self.doc_id = doc_id
        self.retry_after_s = retry_after_s


class ClusterNode:
    """One fleet member: engine + lease + ring view + anti-entropy.
    DocumentStore-compatible (it IS the ``store`` behind
    ``service.http.make_server``)."""

    def __init__(self, name: str, kv, engine: Optional[ServingEngine]
                 = None, *, ttl_s: float = 5.0, max_ids: int = 64,
                 ring_ttl_s: float = 0.25,
                 ae_interval_s: float = 0.25,
                 delta_cap: int = 65_536,
                 forward_retries: int = 4,
                 forward_timeout_s: float = 30.0,
                 forward_budget_s: Optional[float] = None,
                 max_staleness_s: Optional[float] = None,
                 breaker_threshold: int = 5,
                 netchaos=None,
                 vnodes: int = 64,
                 clock=time.time,
                 device=None):
        self.name = name
        self.kv = kv
        # deterministic network fault injection (cluster/netchaos.py):
        # an explicitly armed plan, else the process-wide
        # GRAFT_NETCHAOS one, else None (clean links).  Every outbound
        # fleet connection — anti-entropy, forwarding, repair fetches
        # — rides through it.
        self.netchaos = netchaos if netchaos is not None \
            else netchaos_mod.env_chaos()
        # pooled inter-node connections (cluster/pool.py):
        # every outbound path — anti-entropy, forwarding, repair — now
        # leases from ONE per-node pool whose factory is
        # netchaos.connect, so keep-alive reuse and fault injection
        # compose (a cut poisons exactly the connection it hit)
        self.pool = pool_mod.ConnectionPool(
            connect=lambda src, dst, host, port, timeout:
            netchaos_mod.connect(self.netchaos, src, dst, host, port,
                                 timeout))
        # end-to-end write-forwarding deadline: the retry loop never
        # pins a client handler past this budget — exhausted, the
        # client gets 503 + Retry-After (ForwardError) and retries
        # into failover.  (The old shape, retries × timeout with no
        # total cap, could hold a handler for 2 minutes.)
        self.forward_budget_s = forward_budget_s \
            if forward_budget_s is not None \
            else _env_float("GRAFT_FORWARD_BUDGET_S", 45.0)
        # bounded-staleness server default (0 = reads are never
        # staleness-rejected unless the request carries its own
        # X-Max-Staleness bound)
        self.max_staleness_s = max_staleness_s \
            if max_staleness_s is not None \
            else _env_float("GRAFT_MAX_STALENESS_S", 0.0)
        # each node owns its OWN flight recorder: in-process fleets
        # must not interleave three servers' commit records in one
        # process-wide ring (the oracle tags records per node).  A
        # node's own engine merges on ``device``: the card unless the
        # caller names another (no card and no device= raises)
        self.engine = engine if engine is not None else ServingEngine(
            flight=flight_mod.FlightRecorder(), device=device)
        # fleet mode: served op-logs must NOT auto-stabilize — the
        # causal-stability watermark (the gate on cascade checkpoint
        # advancement + segment GC, oplog.py) is derived here from the
        # anti-entropy marks peers pull with, min'd over the live
        # lease table, so no replica can be stranded needing collected
        # ops.  Flipped before any traffic; pre-existing docs (an
        # embedded engine handed in mid-life) are converted too.
        self.engine.external_stability = True
        for d in self.engine.docs():
            d.tree._log.set_auto_stable(False)
        # fleet-wide causal tracing + write-to-visibility ledger
        # (obs/fleettrace.py, obs/ledger.py; docs/OBSERVABILITY.md
        # §Fleet tracing & visibility ledger): per-node like the
        # flight recorder (in-process fleets share a process), wired
        # onto the engine so record_commit stamps both at the seam
        # every commit already crosses.  GRAFT_FLEETTRACE=0 leaves
        # the objects in place but every stamp and wire header gated
        # off, so the wire carries no tracing header.
        self.fleettrace = fleettrace_mod.FleetTrace(name)
        self.ledger = ledger_mod.VisibilityLedger(name)
        self.engine.fleettrace = self.fleettrace
        self.engine.ledger = self.ledger
        # continuous canary probing (obs/canary.py): armed in start()
        self.canary: Optional[canary_mod.CanaryProber] = None
        self._marks_lock = threading.Lock()
        self._peer_marks: Dict[str, Dict[str, int]] = {}
        self.leases = LeaseService(kv, ttl_s=ttl_s, max_ids=max_ids,
                                   clock=clock)
        self.lease: Optional[Lease] = None
        self.keeper: Optional[LeaseKeeper] = None
        self.antientropy = AntiEntropy(
            self, interval_s=ae_interval_s, delta_cap=delta_cap,
            breaker_threshold=breaker_threshold)
        # scrub-with-peer-repair (docs/DURABILITY.md §Scrub & repair):
        # the maintenance lane's scrub task heals a quarantined range
        # by re-fetching it from a fleet peer through this hook
        self.engine.repair_fetcher = self.repair_fetch
        self.forward_retries = forward_retries
        self.forward_timeout_s = forward_timeout_s
        self.vnodes = vnodes
        self._ring_ttl_s = ring_ttl_s
        self._ring_lock = threading.Lock()
        self._ring: Optional[HashRing] = None
        self._member_names: frozenset = frozenset()
        self._ring_at = 0.0
        self._counter_lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "forwarded_ok": 0, "forwarded_err": 0,
            "forward_retries": 0, "forwarded_in": 0,
            "forward_budget_exhausted": 0,
            "replica_ids_assigned": 0,
            "staleness_503": 0,
            "repair_fetches": 0, "repair_fetch_failures": 0,
        }
        self._last_repair_err: Optional[str] = None
        self.started_at = time.monotonic()

    # -- lifecycle --------------------------------------------------------

    def start(self, advertise_addr: str) -> "ClusterNode":
        """Join the fleet: claim a replica-id lease under our stable
        name (crash-safe: a restart reclaims the old slot with a
        bumped fencing token) and start renewal + anti-entropy."""
        self.lease = self.leases.acquire(self.name, advertise_addr)
        self.keeper = LeaseKeeper(self.leases, self.lease,
                                  on_change=self._lease_changed)
        self.keeper.start()
        self.antientropy.start()
        self.refresh_ring()
        # the canary prober runs by default on fleet nodes
        # (GRAFT_CANARY=0 or a non-positive interval disables it; the
        # first probe fires only after one full interval, so short
        # test fleets never see one under the 30 s default)
        if canary_mod.enabled():
            try:
                self.canary = canary_mod.CanaryProber(self).start()
            except Exception:   # noqa: BLE001 — observability must
                # degrade, never refuse to serve
                self.canary = None
        return self

    def _lease_changed(self, lease: Lease) -> None:
        self.lease = lease
        self.refresh_ring()

    def close(self, graceful: bool = True, timeout: float = 10.0
              ) -> None:
        """``graceful=False`` models a crash: no lease release (the
        slot ages out over the TTL or is force-expired), no drain —
        exactly what a killed process leaves behind."""
        if self.canary is not None:
            self.canary.stop()
        self.antientropy.stop()
        if self.keeper is not None:
            self.keeper.stop()
        if graceful and self.lease is not None:
            try:
                self.leases.release(self.lease)
            except Exception:   # noqa: BLE001 — shutdown boundary
                pass
        self.pool.close()
        self.engine.close(timeout=timeout)

    # -- membership / routing ---------------------------------------------

    def members(self) -> Dict[str, Lease]:
        return self.leases.members()

    def epoch(self) -> int:
        return self.lease.token if self.lease is not None else 0

    def node_id(self) -> int:
        return self.lease.id if self.lease is not None else -1

    def refresh_ring(self) -> HashRing:
        with self._ring_lock:
            members = {name: lease.addr
                       for name, lease in self.members().items()}
            self._ring = HashRing(members, vnodes=self.vnodes)
            self._member_names = frozenset(members)
            self._ring_at = time.monotonic()
            return self._ring

    def ring(self) -> HashRing:
        with self._ring_lock:
            ring, age = self._ring, time.monotonic() - self._ring_at
        if ring is None or age > self._ring_ttl_s:
            return self.refresh_ring()
        return ring

    def live_member_names(self) -> frozenset:
        """The lease table's member names through the ring's TTL cache
        — the per-read lag stamp (``lag_seconds``) must not pay a full
        KV lease scan on every GET."""
        self.ring()
        with self._ring_lock:
            return self._member_names

    def primary_for(self, doc_id: str) -> Optional[str]:
        return self.ring().primary(doc_id)

    def write_route(self, doc_id: str
                    ) -> Optional[Tuple[str, str]]:
        """``(name, addr)`` of the primary to forward a client write
        to, or None when THIS node should apply it (we are primary, we
        are the only member, or we are not in the ring at all — then
        local apply + anti-entropy is strictly better than guessing).
        Name and address come from ONE ring snapshot, so the netchaos
        link label always matches the peer actually dialed."""
        ring = self.ring()
        primary = ring.primary(doc_id)
        if primary is None or primary == self.name:
            return None
        return primary, ring.address(primary)

    # -- write forwarding --------------------------------------------------

    def _count(self, key: str, n: int = 1) -> None:
        with self._counter_lock:
            self.counters[key] = self.counters.get(key, 0) + n

    def forward_write(self, doc_id: str, body: bytes,
                      headers: Dict[str, str]
                      ) -> Optional[Tuple[int, bytes, Dict[str, str]]]:
        """Relay one client write to the document's primary.  Returns
        ``(status, body, headers)`` to answer with, or None when the
        caller should apply locally (we are/became the primary).
        Raises :class:`ForwardError` after the retry budget — or after
        the END-TO-END deadline (``forward_budget_s``): each attempt's
        timeout is clipped to the remaining budget, so the loop can
        never pin a client handler for retries × timeout."""
        detail = "no attempt"
        deadline = time.monotonic() + self.forward_budget_s
        # mint-or-adopt the trace id HERE, not at the primary: a
        # client write without an X-Trace-Id used to forward without
        # one, so the primary minted its own and the forwarding node
        # had no id to attribute the hop — ack and flight record
        # disagreed.  One id now rides the relay and comes back on
        # the ack no matter which node commits (stable across
        # retries, so a failover retry stays attributable too).
        tid = ensure_trace_id(headers.get(TRACE_HEADER))
        for attempt in range(self.forward_retries):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                detail = (f"forward budget "
                          f"({self.forward_budget_s:.0f}s) exhausted "
                          f"after {attempt} attempts: {detail}")
                self._count("forward_budget_exhausted")
                break
            if attempt:
                self._count("forward_retries")
                time.sleep(min(0.25, 0.05 * (2 ** (attempt - 1)),
                               max(0.0, remaining)))
                self.refresh_ring()
            route = self.write_route(doc_id)
            if route is None:
                return None
            primary, addr = route
            host, port = addr.rsplit(":", 1)
            try:
                fwd = {"Content-Type": "application/json",
                       FORWARDED_HEADER: f"{self.name}.{self.epoch()}",
                       TRACE_HEADER: tid}
                v = headers.get(SESSION_HEADER)
                if v:
                    fwd[SESSION_HEADER] = v
                if fleettrace_mod.enabled():
                    fwd[SPAN_CTX_HEADER] = \
                        fleettrace_mod.encode_span_ctx(
                            self.name, "forward")
                t_req = time.perf_counter()
                # pooled relay (cluster/pool.py): a stale keep-alive
                # connection retries once inside the pool (the relayed
                # POST is idempotent — the CRDT absorbs a duplicate);
                # a real failure poisons the pooled connection and
                # burns a forward retry exactly as before
                resp, out_body = self.pool.request(
                    self.name, primary, host, int(port),
                    "POST", f"/docs/{doc_id}/ops", body=body,
                    headers=fwd,
                    timeout=min(self.forward_timeout_s,
                                max(0.05,
                                    deadline - time.monotonic())))
                out_headers = {h: resp.getheader(h)
                               for h in _RELAY_HEADERS
                               if resp.getheader(h)}
                # the ack always carries the id the relay rode under
                # (a primary running an older build might not echo)
                out_headers.setdefault(TRACE_HEADER, tid)
                self.fleettrace.record(
                    tid, "forward", doc=doc_id, peer=primary,
                    ms=round((time.perf_counter() - t_req) * 1e3, 3),
                    status=resp.status)
                # 429 passes straight through (Retry-After intact):
                # the PRIMARY's admission queue is the fleet's
                # backpressure signal, not something to absorb here
                self._count("forwarded_ok")
                return resp.status, out_body, out_headers
            except (OSError, HTTPException) as e:
                # HTTPException covers a primary dying MID-response
                # (IncompleteRead/BadStatusLine are not OSErrors) —
                # exactly what a chaos kill produces; it must burn a
                # retry, not escape the loop
                detail = repr(e)
        self._count("forwarded_err")
        raise ForwardError(doc_id, detail)

    # -- fleet identity on the wire ---------------------------------------

    def extra_read_headers(self, snap,
                           ae_lag_hdr: Optional[str] = None
                           ) -> Dict[str, str]:
        return {
            REPLICA_HEADER: str(self.node_id()),
            REPLICA_NAME_HEADER: self.name,
            REPLICA_EPOCH_HEADER: str(self.epoch()),
            STATE_FP_HEADER: snap.state_fingerprint(),
            # the bounded-staleness contract's observable half: how
            # stale this replica can possibly be, from the
            # anti-entropy marks (docs/CLUSTER.md §Partitions &
            # staleness).  A gated read passes the gate's own sample
            # through (``ae_lag_hdr``) so the stamp can never disagree
            # with the bound it was served under — and the lag is
            # computed once per request, not once per consumer.
            AE_LAG_HEADER: ae_lag_hdr if ae_lag_hdr is not None
            else f"{self.ae_lag_seconds():.3f}",
        }

    def ae_lag_seconds(self) -> float:
        return self.antientropy.lag_seconds()

    def check_staleness(self, bound_header: Optional[str]
                        ) -> Tuple[Optional[Dict], str]:
        """Bounded-staleness read gate (service/http.py consults it
        before serving a fleet read): the effective bound is the
        request's ``X-Max-Staleness`` (seconds) when well-formed, else
        the server-wide ``GRAFT_MAX_STALENESS_S`` default; 0/absent =
        unbounded, ``+inf`` an explicit unbounded request that
        overrides even a strict default.  Returns ``(verdict,
        lag_header)``: verdict None to serve, else the 503 payload —
        honest refusal instead of silently stale data while
        partitioned.  ``lag_header`` is the ``X-Ae-Lag-Seconds`` stamp
        from the SAME lag sample the gate judged, and the payload's
        ``lag_s`` is JSON-safe: None (never ``Infinity``, which is not
        RFC 8259 JSON) when the lag is unbounded — a replica that has
        never fully synced since daemon start."""
        import math
        lag = self.ae_lag_seconds()
        lag_hdr = f"{lag:.3f}"          # inf formats as "inf"
        bound = None
        if bound_header:
            try:
                bound = float(bound_header)
            except ValueError:
                bound = None        # malformed: fall to server default
            if bound is not None and not math.isfinite(bound):
                # +inf is an EXPLICIT unbounded request; nan (compares
                # False against any lag: a permanent 503) and -inf are
                # malformed and fall back rather than wedging the
                # read path
                if bound > 0:
                    return None, lag_hdr
                bound = None
        if bound is None:
            bound = self.max_staleness_s
        if not bound or bound <= 0:
            return None, lag_hdr
        if lag <= bound:
            return None, lag_hdr
        self._count("staleness_503")
        retry = max(1, min(30, int(
            self.antientropy.interval_s * 2 + 0.999)))
        return {"lag_s": round(lag, 3) if math.isfinite(lag)
                else None,
                "bound_s": bound, "retry_after_s": retry}, lag_hdr

    def served_by(self) -> Dict[str, object]:
        """Write-response attribution (the committing node)."""
        return {"id": self.node_id(), "name": self.name,
                "epoch": self.epoch()}

    def assign_replica(self, doc_id: str) -> int:
        """Fleet-unique CLIENT replica id from the KV counter."""
        rid = kv_mod.next_counter(self.kv, f"replica/{doc_id}")
        self._count("replica_ids_assigned")
        return rid

    def note_forwarded_in(self) -> None:
        self._count("forwarded_in")

    # -- fleet tracing + visibility (docs/OBSERVABILITY.md) ----------------

    def note_span_ctx(self, trace_id: str,
                      ctx_header: Optional[str]) -> None:
        """An inbound request carried ``X-Span-Ctx`` (service/http.py
        hands it through): record the receiving half of the hop, with
        the cross-clock transport delta as a BOUND."""
        ctx = fleettrace_mod.parse_span_ctx(ctx_header)
        if ctx is None:
            return
        sender, kind, send_ts_ms = ctx
        bound_ms = round(max(0.0, time.time() - send_ts_ms / 1e3)
                         * 1e3, 3)
        self.fleettrace.record(trace_id, kind, peer=sender,
                               bound_ms=bound_ms, dir="in")

    def note_ae_window(self, doc_id: str, peer: str,
                       frontier_header: Optional[str]) -> None:
        """An anti-entropy window from ``peer`` just applied locally
        and carried a trace frontier: stamp visible-at-replica on this
        (pulling) node — ``ae_apply`` spans for the commits the window
        carried, and the ledger's replica-stage bound."""
        parsed = fleettrace_mod.parse_frontier(frontier_header)
        if parsed is None or not fleettrace_mod.enabled():
            return
        send_ts_ms, tids = parsed
        bound_ms = round(max(0.0, time.time() - send_ts_ms / 1e3)
                         * 1e3, 3)
        for tid in tids:
            self.fleettrace.record(tid, "ae_apply", doc=doc_id,
                                   peer=peer, bound_ms=bound_ms)
        self.ledger.note_replica_apply(doc_id, peer, send_ts_ms, tids)

    def note_watch_delivery(self, doc_id: str, seq: int) -> None:
        """First watch delivery of generation ``seq`` (the hook
        ``serve.watch.delivery_headers`` calls — threaded and reactor
        egress share that one builder): delivered-to-watchers in the
        ledger plus a ``watch_delivery`` span per commit trace id."""
        if not fleettrace_mod.enabled():
            return
        tids = self.ledger.note_watch_delivery(doc_id, seq)
        if tids:
            for tid in tids:
                self.fleettrace.record(tid, "watch_delivery",
                                       doc=doc_id, seq=seq)

    def trace_frontier_header(self, doc_id: str) -> Optional[str]:
        """The ``X-Trace-Frontier`` stamp for a windowed ``/ops``
        response (service/http.py adds it to both the buffered and
        the sendfile-plan paths); None when the tier is off."""
        return self.fleettrace.frontier_header(doc_id)

    def debug_trace(self, trace_id: str,
                    federate: bool = True) -> Dict:
        """``GET /debug/trace/{id}``: this node's spans, plus — when
        federating — ONE bounded fetch per live peer (``?federate=0``
        stops recursion) merged into a wall-clock-ordered span tree.
        Cross-node ordering rides wall clocks, so it is a display
        order, not a truth (the skew caveat)."""
        local = self.fleettrace.spans(trace_id)
        out: Dict = {"trace_id": trace_id, "node": self.name,
                     "spans": local, "peers": {}}
        if not federate or not fleettrace_mod.enabled():
            return out
        members = self.members()
        names = set(members) | set(
            self.fleettrace.known_nodes(trace_id))
        for peer in sorted(names - {self.name}):
            lease = members.get(peer)
            if lease is None:
                continue
            host, port = lease.addr.rsplit(":", 1)
            try:
                resp, body = self.pool.request(
                    self.name, peer, host, int(port), "GET",
                    f"/debug/trace/{trace_id}?federate=0",
                    timeout=5.0)
                if resp.status != 200:
                    out["peers"][peer] = None
                    continue
                remote = json.loads(body)
                out["peers"][peer] = remote.get("spans", [])
                self.fleettrace.federated_fetches += 1
            except (OSError, HTTPException, ValueError):
                out["peers"][peer] = None
        merged = list(local)
        for spans in out["peers"].values():
            if spans:
                merged.extend(spans)
        merged.sort(key=lambda s: s.get("t_wall", 0.0))
        out["tree"] = merged
        out["kinds"] = sorted({s.get("kind") for s in merged
                               if s.get("kind")})
        out["skew_note"] = ("cross-node ordering uses wall clocks — "
                            "a display order, not a truth")
        return out

    def debug_visibility(self, doc_id: str) -> Dict:
        """``GET /debug/visibility/{doc}``: the ledger tail."""
        return self.ledger.tail(doc_id)

    # -- rejoining-node catch-up ---------------------------------------------

    def catchup_status(self, doc_id: str) -> Optional[Dict[str, int]]:
        """A read asked for a document this node doesn't hold.  If a
        live peer's ``/docs`` listing includes it, the document EXISTS
        and this node is merely behind (a restart, or fresh ownership
        after a rebalance): trigger a priority anti-entropy pull and
        return the 503 hint the HTTP layer serves instead of a 404 —
        ``retry_after_s`` (one-ish sync interval) and ``remaining``
        (the best local estimate of ops still to pull: the
        peer-holding count until the first window lands, after which
        the doc exists locally and reads stop landing here).  None =
        no peer has it either — a genuine 404."""
        peers = self.antientropy.peers_with(doc_id)
        if not peers:
            return None
        self._count("catchup_503")
        self.antientropy.request_priority(doc_id)
        retry = max(1, int(self.antientropy.interval_s * 2 + 0.999))
        return {"retry_after_s": retry, "remaining": len(peers)}

    # -- scrub peer repair (docs/DURABILITY.md §Scrub & repair) ------------

    def repair_fetch(self, doc_id: str, spec: Dict[str, int]):
        """Re-fetch the op rows a quarantined tier file covered from a
        fleet peer, through the ORDINARY ``packed_since_window`` wire
        (no new protocol): ``spec`` names the global row range
        ``[start, stop)`` plus the window-chain entry point — ``since``
        (the last Add timestamp strictly before ``start``, from the
        neighboring tiers' resident indexes) and ``p0`` (that Add's
        global position; 0/0 when the range starts the log).  Returns
        a ``PackedOps`` of exactly ``stop-start`` rows or None (peer
        down, diverged, or still behind — the quarantine stands and
        the next scrub retries).  Peers with an open circuit breaker
        are skipped: the daemon already knows they're unreachable."""
        peers = self.antientropy.peers_with(doc_id)
        members = self.members()
        for peer in peers:
            if self.antientropy.breaker_open(peer):
                continue
            lease = members.get(peer)
            if lease is None:
                continue
            try:
                rows = self._fetch_range(peer, lease.addr, doc_id,
                                         spec)
            except (OSError, HTTPException, ValueError, KeyError,
                    IndexError) as e:
                self._last_repair_err = repr(e)
                rows = None
            if rows is not None:
                self._count("repair_fetches")
                return rows
        self._count("repair_fetch_failures")
        return None

    def _fetch_range(self, peer: str, addr: str, doc_id: str,
                     spec: Dict[str, int]):
        """One peer's window chain → the requested row range.  Windows
        resume on the inclusive Add terminator, so every window after
        the first overlaps the previous by exactly its first row."""
        import numpy as np

        from ..codec import packed as packed_mod
        start, stop = int(spec["start"]), int(spec["stop"])
        since, pos = int(spec["since"]), int(spec["p0"])
        p0 = pos
        host, port = addr.rsplit(":", 1)
        pieces = []
        first = True
        conn = self.pool.lease(self.name, peer, host, int(port),
                               self.forward_timeout_s)
        ok = True
        try:
            for _ in range(self.antientropy.max_windows_per_doc):
                if pos >= stop:
                    break
                # segment-sized repair pulls : ask for the
                # whole remaining range at once when it exceeds the
                # steady-state delta cap — a cold range on the peer
                # then ships as ONE zero-copy sendfile plan instead
                # of many small re-encoded windows
                limit = max(self.antientropy.delta_cap, stop - pos)
                conn.request(
                    "GET", f"/docs/{doc_id}/ops?since={since}"
                           f"&limit={limit}")
                resp = conn.getresponse()
                body = resp.read()
                if resp.status != 200:
                    return None
                if resp.getheader(SINCE_FOUND_HEADER) == "0":
                    # the peer no longer resolves our mark (fresh log
                    # after a restart): its rows are not OUR rows
                    return None
                p = packed_mod.pack_json(body)
                n = p.num_ops
                skip = 0 if first else 1
                first = False
                if n > skip:
                    piece = p if skip == 0 else packed_mod.select_rows(
                        p, np.arange(skip, n))
                    pieces.append(piece)
                    pos += n - skip
                if pos >= stop:
                    break
                nxt = resp.getheader(SINCE_NEXT_HEADER)
                if resp.getheader(SINCE_MORE_HEADER) != "1" \
                        or nxt is None:
                    # the peer's log ends before our range does — it
                    # hasn't converged up to the corrupt rows yet
                    return None
                since = int(nxt)
            else:
                return None
        except BaseException:
            # any transport/chaos failure poisons exactly this pooled
            # connection; the outer repair_fetch catch decides whether
            # it is a peer failure
            ok = False
            raise
        finally:
            self.pool.release(conn, ok=ok)
        if pos < stop or not pieces:
            return None
        merged = pieces[0] if len(pieces) == 1 \
            else packed_mod.concat_many(pieces)
        off = start - p0
        if off < 0 or merged.num_ops < off + (stop - start):
            return None
        return packed_mod.select_rows(
            merged, np.arange(off, off + (stop - start)))

    # -- causal-stability watermark (cascade op-log GC gate) ---------------

    def note_peer_mark(self, doc_id: str, peer: str,
                       since: int) -> None:
        """Record the ``since`` mark a peer's anti-entropy pull carried
        (``X-Ae-Peer`` — service/http.py): the peer had consumed our
        log through that Add when it asked, so positions at or below it
        are safe to fold once EVERY live peer clears them.  A reset
        pull (``since=0``) legitimately lowers the mark — the
        watermark min()s, so the gate only ever errs closed."""
        with self._marks_lock:
            self._peer_marks.setdefault(doc_id, {})[peer] = since

    def update_stability(self) -> None:
        """Fold the recorded peer marks into each served document's
        stability watermark — min over the LIVE lease table's members
        (a member that has never pulled holds the watermark at 0, so a
        fresh joiner is never stranded; a departed member stops
        counting) — then run the cascade's watermark-gated GC."""
        members = set(self.members()) - {self.name}
        docs = self.engine.docs()
        # prune: marks from departed members (or arbitrary X-Ae-Peer
        # values — the header is unauthenticated) and from unknown doc
        # ids must not accumulate forever; only live-member marks for
        # served docs participate in the watermark anyway
        with self._marks_lock:
            doc_ids = {d.doc_id for d in docs}
            self._peer_marks = {
                doc: kept
                for doc, by_peer in self._peer_marks.items()
                if doc in doc_ids
                and (kept := {p: m for p, m in by_peer.items()
                              if p in members})}
        for d in docs:
            log = d.tree._log
            if not log.tiering_enabled:
                continue
            if not members:
                pos = d.tree.log_length
            else:
                with self._marks_lock:
                    marks = dict(self._peer_marks.get(d.doc_id, {}))
                pos = None
                for peer in members:
                    m = marks.get(peer)
                    if not m:
                        p_pos = 0
                    else:
                        idx = log.index_of_add(m)
                        p_pos = idx if idx is not None else 0
                    pos = p_pos if pos is None else min(pos, p_pos)
            log.set_stable_mark(pos)
            log.run_gc()

    # -- store surface (service/http.py duck type) ------------------------

    def get(self, doc_id: str, create: bool = True):
        return self.engine.get(doc_id, create=create)

    def ids(self) -> List[str]:
        return self.engine.ids()

    def docs(self):
        return self.engine.docs()

    @staticmethod
    def encode_ops(op) -> str:
        return ServingEngine.encode_ops(op)

    @staticmethod
    def decode_ops(payload):
        return ServingEngine.decode_ops(payload)

    def flush(self, timeout: float = 60.0) -> bool:
        return self.engine.flush(timeout=timeout)

    @property
    def scheduler(self):
        return self.engine.scheduler

    @property
    def flight(self):
        return self.engine.flight

    @property
    def reactor(self):
        # reactor egress (serve/reactor.py): the watch detach seam
        # resolves the reactor through the store, so a fleet node's
        # watchers park selector-side exactly like a single engine's —
        # with the fleet lag stamps re-sampled at delivery through
        # extra_read_headers
        return self.engine.reactor

    def cluster_stats(self) -> Dict:
        with self._counter_lock:
            counters = dict(self.counters)
        members = self.members()
        local_docs = self.ids()
        ring = self.ring()
        return {
            "node": {"name": self.name, "id": self.node_id(),
                     "epoch": self.epoch(),
                     "addr": self.lease.addr if self.lease else None,
                     "lease_remaining_s": round(
                         self.lease.expires - self.leases.clock(), 3)
                     if self.lease else None,
                     "lease_losses": self.keeper.losses
                     if self.keeper else 0,
                     "lease_reacquired": self.keeper.reacquired
                     if self.keeper else 0},
            "members": {name: {"id": ls.id, "addr": ls.addr,
                               "epoch": ls.token}
                        for name, ls in sorted(members.items())},
            "ring": {"vnodes": self.vnodes,
                     "spread": ring.spread(local_docs)},
            "primaries": {d: ring.primary(d) for d in local_docs},
            "counters": counters,
            "antientropy": self.antientropy.stats(),
            # JSON-safe: unbounded (never-synced) lag is null on the
            # wire — json.dumps would emit the literal Infinity, which
            # is not RFC 8259 JSON.  Prom re-expands None to +Inf.
            "ae_lag_s": round(lag, 3)
            if (lag := self.ae_lag_seconds()) != float("inf")
            else None,
            "max_staleness_s": self.max_staleness_s,
            "netchaos": None if self.netchaos is None
            else self.netchaos.stats(),
            # pooled inter-node connections (cluster/pool.py)
            "connpool": self.pool.stats(),
            "last_repair_err": self._last_repair_err,
            # fleet tracing + visibility + canary: None
            # when the tier is off, so the prom families disappear
            # with it — and they never exist on non-fleet engines
            "fleettrace": self.fleettrace.stats()
            if fleettrace_mod.enabled() else None,
            "visibility": self.ledger.stats()
            if fleettrace_mod.enabled() else None,
            "canary": self.canary.stats()
            if self.canary is not None else None,
        }

    def cluster_view(self) -> Dict:
        """``GET /cluster``."""
        return self.cluster_stats()

    def scheduler_metrics(self) -> Dict:
        out = self.engine.scheduler_metrics()
        out["cluster"] = self.cluster_stats()
        return out

    def render_prom(self) -> str:
        return prom_mod.render_engine(self.engine) \
            + prom_mod.render_cluster(self)

    def debug_flight(self) -> Dict:
        return self.engine.debug_flight()


class FleetServer:
    """One in-process fleet member: node + real HTTP server on its own
    localhost port.  The unit the tests and ``chip_smoke.py``'s fleet
    phase compose."""

    def __init__(self, name: str, kv, port: int = 0,
                 engine: Optional[ServingEngine] = None,
                 **node_kw):
        from ..service import make_server
        self.node = ClusterNode(name, kv, engine=engine, **node_kw)
        self.server = make_server(port=port, store=self.node)
        self.port = self.server.server_port
        self.addr = f"127.0.0.1:{self.port}"
        self._thread = threading.Thread(
            target=self.server.serve_forever,
            name=f"fleet-http-{name}", daemon=True)
        self._thread.start()
        self.node.start(self.addr)

    @property
    def name(self) -> str:
        return self.node.name

    def stop(self) -> None:
        """Graceful leave: release the lease so the membership change
        is immediate."""
        self.server.shutdown()
        self.server.server_close()
        self.node.close(graceful=True)

    def crash(self) -> None:
        """Model ``kill -9`` as closely as one process can: stop
        listening, fail every queued ticket immediately (timeout 0 —
        no drain, so an unpublished merge's acks die as 503s) and do
        NOT release the lease — peers discover the death by lease
        expiry (or an operator ``expire_now``), exactly like a real
        dead process.  The genuinely preemptive kill (a merge dying
        mid-kernel) is the process-level chaos test's job
        (a real process and SIGKILL)."""
        self.server.shutdown()
        self.server.server_close()
        self.node.close(graceful=False, timeout=0.0)
