"""Deterministic network fault injection for every inter-node HTTP
client path (docs/CLUSTER.md §Partitions & staleness).

The fleet's distribution contract is pure anti-entropy — it only
converges if it survives the network actually misbehaving.  This module
makes the network misbehave ON PURPOSE, reproducibly: a
:class:`NetChaos` instance wraps every outbound fleet connection
(anti-entropy pulls, write forwarding, scrub peer-repair fetches, and
any client that dials through it) in a :class:`ChaosHTTPConnection`
that consults a seeded per-link decision stream before and after each
request.  Same seed + same spec + same per-link request sequence ⇒ the
exact same faults, so a partition test is a replayable artifact, not a
flake — chaos tests print ``describe()`` so any red run replays
verbatim.

Faults (all optional, combined freely):

- **drop** — the request never reaches the peer (``ConnectionRefused``
  before any bytes move: the same shape a dead/unroutable peer has);
- **delay** — seeded latency before the request is sent;
- **throttle** — response bandwidth cap (the body "arrives" at N
  bytes/s: a sleep proportional to its size before ``read`` returns);
- **cut** — the peer dies mid-response: ``read()`` delivers a prefix
  and raises :class:`http.client.IncompleteRead` (an HTTPException,
  NOT an OSError — exactly the class the fleet paths must already
  catch, docs/CLUSTER.md §Failure matrix);
- **dup** — duplicate/reordered delivery: the link re-serves the
  PREVIOUS response for the same endpoint instead of the fresh one
  (an anti-entropy puller then applies an older window again and its
  mark regresses — the CRDT absorbs both, which is the point);
- **partitions** — full, asymmetric, and flapping link cuts, driven
  either by spec clauses over the per-link request index (replayable
  schedules) or programmatically (:meth:`NetChaos.block` /
  :meth:`heal` — the deterministic tier-1 matrix drives these).

Spec grammar (``GRAFT_NETCHAOS="<seed>:<clause>[;<clause>...]"``)::

    drop=P                 drop a request with probability P
    delay=LO-HI@P          sleep LO..HI ms with probability P
    throttle=BPS           response bandwidth cap, bytes/second
    cut=P                  cut a response mid-body with probability P
    dup=P                  re-deliver the link's previous response
    part=A|B@LO-HI         symmetric partition between groups A and B
                           for link request indexes [LO, HI)
    oneway=A>B@LO-HI       asymmetric: only A→B requests blocked
    flap=A|B@PERIOD/DUTY   flapping partition: blocked while
                           (link request index % PERIOD) < DUTY

Groups are ``+``-joined node names or ``*`` (any).  Example: a fleet
where ``n2`` is cut off for its first 40 cross-link requests, over a
generally lossy slow network::

    GRAFT_NETCHAOS="7:drop=0.05;delay=5-40@0.5;part=n2|*@0-40"

Schedules are indexed by the per-link REQUEST COUNTER, not wall time,
so replays do not depend on thread timing.  Every decision draws from
a per-link ``random.Random(f"{seed}|{src}>{dst}")`` stream.

Pooled connections (cluster/pool.py): fleet clients now
keep-alive and POOL their connections, created through :func:`connect`
— the decision stream is consulted per WIRE REQUEST (``request()``
calls ``decide``), so a long-lived pooled connection draws exactly the
same per-link fault sequence per-request connections did, and the pool
poisons (evicts) exactly the connection a cut/drop fired on.
``getresponse`` fully buffers the real response before faulting at
``read()``, so an injected cut never leaves stranded bytes that would
corrupt the NEXT request on a reused connection.  Replay caveat: the
counter indexes wire requests, so anything that RE-SENDS — a client
429/503 retry loop, or the pool's one stale-reuse retry after a peer
closed an idle connection — consumes an additional decision, exactly
as it did pre-pooling; deterministic tier-1 matrices drive
programmatic ``block``/``heal`` (counter-independent) or in-process
fleets whose servers never idle-close, so their schedules replay
verbatim.
"""
from __future__ import annotations

import os
import random
import re
import threading
import time
from http.client import HTTPConnection, IncompleteRead
from typing import Dict, FrozenSet, List, Optional, Tuple

# bodies above this are not cached for dup re-delivery (the cache holds
# at most one response per (link, endpoint) — this bounds it further)
_DUP_CACHE_MAX_BODY = 1 << 20
# throttle sleeps are capped so a tiny configured bandwidth cannot
# wedge a test harness past its own timeouts
_THROTTLE_SLEEP_CAP_S = 5.0

_CLAUSE_RE = re.compile(r"^(\w+)=(.*)$")
_PART_RE = re.compile(r"^([^|>@]+)([|>])([^@]+)@(\d+)-(\d+)$")
_FLAP_RE = re.compile(r"^([^|@]+)\|([^@]+)@(\d+)/(\d+)$")


class NetChaosSpecError(ValueError):
    """The ``GRAFT_NETCHAOS`` spec string failed to parse (the error
    message carries the offending clause; the grammar lives in the
    module docstring and docs/CLUSTER.md)."""


def _group(text: str) -> FrozenSet[str]:
    names = frozenset(n for n in text.split("+") if n)
    if not names:
        raise NetChaosSpecError(f"empty node group in {text!r}")
    return names


def _in_group(name: str, group: FrozenSet[str]) -> bool:
    return "*" in group or name in group


class _Partition:
    """One scheduled link cut: symmetric or one-way, active for link
    request indexes [lo, hi) — or flapping with (period, duty)."""

    __slots__ = ("a", "b", "oneway", "lo", "hi", "period", "duty")

    def __init__(self, a, b, oneway=False, lo=0, hi=1 << 62,
                 period=0, duty=0):
        self.a, self.b, self.oneway = a, b, oneway
        self.lo, self.hi = lo, hi
        self.period, self.duty = period, duty

    def crosses(self, src: str, dst: str) -> bool:
        if _in_group(src, self.a) and _in_group(dst, self.b):
            return True
        if not self.oneway and _in_group(src, self.b) \
                and _in_group(dst, self.a):
            return True
        return False

    def active(self, idx: int) -> bool:
        if self.period:
            return idx % self.period < self.duty
        return self.lo <= idx < self.hi


class _LinkState:
    __slots__ = ("rng", "n", "last_resp")

    def __init__(self, seed: int, src: str, dst: str):
        self.rng = random.Random(f"{seed}|{src}>{dst}")
        self.n = 0                       # request index on this link
        # (endpoint) -> (status, reason, headers, body) — the dup
        # fault's re-delivery source; at most one entry per endpoint
        self.last_resp: Dict[str, tuple] = {}


class _Plan:
    """Per-request fault decisions, drawn at request() time."""

    __slots__ = ("delay_s", "throttle_bps", "cut", "dup")

    def __init__(self):
        self.delay_s = 0.0
        self.throttle_bps = 0
        self.cut = False
        self.dup = False


class NetChaos:
    """One fleet's fault plan: parsed spec clauses + programmatic
    partitions + per-link seeded decision streams + fired counters
    (the ``crdt_netchaos_*`` prom families)."""

    def __init__(self, seed: int = 0, spec: str = ""):
        self.seed = int(seed)
        self.spec = spec or ""
        self.drop_p = 0.0
        self.delay: Optional[Tuple[float, float, float]] = None
        self.throttle_bps = 0
        self.cut_p = 0.0
        self.dup_p = 0.0
        self.partitions: List[_Partition] = []
        self._mu = threading.Lock()
        self._links: Dict[Tuple[str, str], _LinkState] = {}
        # programmatic partitions (the deterministic tier-1 matrix):
        # (src, dst) pairs blocked RIGHT NOW, direction-sensitive
        self._blocked: set = set()
        self.counters: Dict[str, int] = {
            "requests": 0, "drops": 0, "delays": 0, "throttles": 0,
            "cuts": 0, "dups": 0, "partition_blocks": 0,
        }
        for clause in filter(None,
                             (c.strip() for c in self.spec.split(";"))):
            self._parse_clause(clause)

    # -- construction ------------------------------------------------------

    @classmethod
    def parse(cls, raw: str) -> "NetChaos":
        """``"<seed>:<spec>"`` (or just ``"<seed>"``) → an instance.
        Raises :class:`NetChaosSpecError` with the grammar hint on any
        malformed value — the one parser behind ``GRAFT_NETCHAOS``
        and the ``--netchaos`` flag."""
        seed, _, spec = raw.strip().partition(":")
        try:
            return cls(int(seed), spec)
        except ValueError as e:
            raise NetChaosSpecError(
                f"{raw!r}: {e} (grammar: "
                f"'<seed>:drop=P;delay=LO-HI@P;throttle=BPS;cut=P;"
                f"dup=P;part=A|B@LO-HI;oneway=A>B@LO-HI;"
                f"flap=A|B@PERIOD/DUTY')") from e

    @classmethod
    def from_env(cls, var: str = "GRAFT_NETCHAOS"
                 ) -> Optional["NetChaos"]:
        """The env entry: an instance from ``GRAFT_NETCHAOS``, or None
        when unset — the multi-process soak's way of arming one
        identical plan in every node process."""
        raw = os.environ.get(var, "").strip()
        if not raw:
            return None
        return cls.parse(raw)

    def _parse_clause(self, clause: str) -> None:
        m = _CLAUSE_RE.match(clause)
        if not m:
            raise NetChaosSpecError(f"unparseable clause {clause!r}")
        key, val = m.group(1), m.group(2)
        try:
            if key == "drop":
                self.drop_p = float(val)
            elif key == "delay":
                rng_part, _, p = val.partition("@")
                rng_part = rng_part.removesuffix("ms")
                lo, _, hi = rng_part.partition("-")
                lo_ms = float(lo)
                hi_ms = float(hi) if hi else lo_ms
                self.delay = (lo_ms / 1e3, hi_ms / 1e3,
                              float(p) if p else 1.0)
            elif key == "throttle":
                self.throttle_bps = int(float(val))
            elif key == "cut":
                self.cut_p = float(val)
            elif key == "dup":
                self.dup_p = float(val)
            elif key in ("part", "oneway"):
                pm = _PART_RE.match(val)
                if not pm:
                    raise ValueError(f"want A|B@LO-HI, got {val!r}")
                a, sep, b, lo, hi = pm.groups()
                oneway = key == "oneway" or sep == ">"
                self.partitions.append(_Partition(
                    _group(a), _group(b), oneway=oneway,
                    lo=int(lo), hi=int(hi)))
            elif key == "flap":
                fm = _FLAP_RE.match(val)
                if not fm:
                    raise ValueError(f"want A|B@PERIOD/DUTY, got {val!r}")
                a, b, period, duty = fm.groups()
                if int(period) <= 0 or not 0 < int(duty) <= int(period):
                    raise ValueError(
                        f"flap needs 0 < DUTY <= PERIOD, got {val!r}")
                self.partitions.append(_Partition(
                    _group(a), _group(b),
                    period=int(period), duty=int(duty)))
            else:
                raise ValueError(f"unknown fault kind {key!r}")
        except (ValueError, TypeError) as e:
            if isinstance(e, NetChaosSpecError):
                raise
            raise NetChaosSpecError(
                f"clause {clause!r}: {e}") from e

    def describe(self) -> str:
        """The replay line chaos tests print on failure: rebuilding a
        ``NetChaos(seed, spec)`` from it reproduces every decision."""
        return f"GRAFT_NETCHAOS={self.seed}:{self.spec}"

    # -- programmatic partitions (deterministic tier-1 matrices) -----------

    def block(self, src: str, dst: str, oneway: bool = False) -> None:
        """Cut the link ``src → dst`` now (and ``dst → src`` unless
        ``oneway``) until :meth:`unblock`/:meth:`heal`."""
        with self._mu:
            self._blocked.add((src, dst))
            if not oneway:
                self._blocked.add((dst, src))

    def block_groups(self, a, b, oneway: bool = False) -> None:
        """Cut every link between node groups ``a`` and ``b``."""
        for s in a:
            for d in b:
                self.block(s, d, oneway=oneway)

    def unblock(self, src: str, dst: str) -> None:
        with self._mu:
            self._blocked.discard((src, dst))
            self._blocked.discard((dst, src))

    def heal(self) -> None:
        """Lift every programmatic partition (spec-scheduled clauses
        keep their own [lo, hi) windows)."""
        with self._mu:
            self._blocked.clear()

    # -- the per-request decision ------------------------------------------

    def _link(self, src: str, dst: str) -> _LinkState:
        key = (src, dst)
        st = self._links.get(key)
        if st is None:
            st = self._links[key] = _LinkState(self.seed, src, dst)
        return st

    def decide(self, src: str, dst: str) -> _Plan:
        """Draw this request's fate.  Raises ``ConnectionRefusedError``
        for drops and partition blocks (the caller's existing
        peer-failure handling must treat chaos exactly like a dead
        peer — that is the test).  Sleeps the delay before returning
        so the caller's ``request()`` sees it as network latency."""
        with self._mu:
            link = self._link(src, dst)
            idx = link.n
            link.n += 1
            self.counters["requests"] += 1
            blocked = (src, dst) in self._blocked or any(
                p.crosses(src, dst) and p.active(idx)
                for p in self.partitions)
            plan = _Plan()
            delay_s = 0.0
            if blocked:
                self.counters["partition_blocks"] += 1
            else:
                rng = link.rng
                if self.drop_p and rng.random() < self.drop_p:
                    self.counters["drops"] += 1
                    blocked = True
                else:
                    if self.delay is not None:
                        lo, hi, p = self.delay
                        if rng.random() < p:
                            delay_s = rng.uniform(lo, hi)
                            self.counters["delays"] += 1
                    if self.cut_p and rng.random() < self.cut_p:
                        plan.cut = True
                        self.counters["cuts"] += 1
                    if self.dup_p and rng.random() < self.dup_p:
                        plan.dup = True
                    plan.throttle_bps = self.throttle_bps
                    if self.throttle_bps:
                        self.counters["throttles"] += 1
        if blocked:
            raise ConnectionRefusedError(
                f"netchaos: link {src}->{dst} blocked "
                f"(request #{idx}; {self.describe()})")
        if delay_s > 0.0:
            time.sleep(delay_s)
        plan.delay_s = delay_s
        return plan

    # -- dup cache ---------------------------------------------------------

    def stale_response(self, src: str, dst: str, endpoint: str,
                       fresh: tuple) -> tuple:
        """Dup fault: remember ``fresh`` and return the link's PREVIOUS
        response for the same endpoint (or ``fresh`` itself when none
        is cached yet).  The fresh response is always what the NEXT
        delivery sees — a genuine reordering, never a fabrication."""
        with self._mu:
            link = self._link(src, dst)
            prev = link.last_resp.get(endpoint)
            if len(fresh[3]) <= _DUP_CACHE_MAX_BODY:
                link.last_resp[endpoint] = fresh
            if prev is None:
                return fresh
            self.counters["dups"] += 1
            return prev

    def remember_response(self, src: str, dst: str, endpoint: str,
                          resp: tuple) -> None:
        if self.dup_p <= 0.0 or len(resp[3]) > _DUP_CACHE_MAX_BODY:
            return
        with self._mu:
            self._link(src, dst).last_resp[endpoint] = resp

    # -- exposition --------------------------------------------------------

    def stats(self) -> Dict:
        with self._mu:
            return {
                "seed": self.seed,
                "spec": self.spec,
                "links": len(self._links),
                "blocked_links": len(self._blocked),
                "counters": dict(self.counters),
            }


class _ChaosResponse:
    """A fully buffered response standing in for ``HTTPResponse``:
    ``status``/``reason``/``read``/``getheader``/``getheaders`` — the
    surface every fleet client path consumes.  Throttle and cut faults
    fire at ``read()`` time (the body is where the bytes are)."""

    def __init__(self, status: int, reason: str,
                 headers: List[Tuple[str, str]], body: bytes,
                 plan: _Plan):
        self.status = status
        self.reason = reason
        self._headers = headers
        self._body = body
        self._plan = plan
        self._consumed = False

    def read(self, amt: Optional[int] = None) -> bytes:
        if self._consumed:
            return b""
        self._consumed = True
        plan = self._plan
        if plan.throttle_bps > 0 and self._body:
            time.sleep(min(_THROTTLE_SLEEP_CAP_S,
                           len(self._body) / plan.throttle_bps))
        if plan.cut:
            # the peer died mid-body: deliver a prefix, then the same
            # exception a real half-closed socket raises
            raise IncompleteRead(self._body[:len(self._body) // 2])
        return self._body

    def getheader(self, name: str, default=None):
        low = name.lower()
        for k, v in self._headers:
            if k.lower() == low:
                return v
        return default

    def getheaders(self) -> List[Tuple[str, str]]:
        return list(self._headers)


class ChaosHTTPConnection(HTTPConnection):
    """An ``HTTPConnection`` whose requests pass through a
    :class:`NetChaos` decision stream.  Drop-in: ``request`` may raise
    ``ConnectionRefusedError`` (drop/partition), ``getresponse`` returns
    a :class:`_ChaosResponse` whose ``read`` may raise
    ``IncompleteRead`` (cut) — both failure classes the fleet client
    paths already handle for REAL network failures."""

    def __init__(self, chaos: NetChaos, src: str, dst: str,
                 host: str, port: int, timeout: float):
        super().__init__(host, port, timeout=timeout)
        self._chaos = chaos
        self._src = src
        self._dst = dst
        self._plan: Optional[_Plan] = None
        self._endpoint = ""

    def request(self, method, url, body=None, headers=None, **kw):
        # the decision (and any injected latency/refusal) happens
        # BEFORE bytes move, like the network it models
        self._plan = self._chaos.decide(self._src, self._dst)
        self._endpoint = f"{method} {url.partition('?')[0]}"
        super().request(method, url, body=body,
                        headers=headers or {}, **kw)

    def getresponse(self):
        plan = self._plan or _Plan()
        self._plan = None
        real = super().getresponse()
        fresh = (real.status, real.reason, real.getheaders(),
                 real.read())
        if plan.dup:
            status, reason, headers, data = self._chaos.stale_response(
                self._src, self._dst, self._endpoint, fresh)
        else:
            self._chaos.remember_response(self._src, self._dst,
                                          self._endpoint, fresh)
            status, reason, headers, data = fresh
        return _ChaosResponse(status, reason, headers, data, plan)


# -- module-level env instance (multi-process soaks) -----------------------

_env_chaos: Optional[NetChaos] = None
_env_read = False
_env_mu = threading.Lock()


def env_chaos() -> Optional[NetChaos]:
    """The process-wide ``GRAFT_NETCHAOS`` instance (parsed once,
    lazily) — what :func:`connect` falls back to when the caller has
    no explicitly armed plan."""
    global _env_chaos, _env_read
    with _env_mu:
        if not _env_read:
            _env_chaos = NetChaos.from_env()
            _env_read = True
        return _env_chaos


def reset_env_chaos() -> None:
    """Forget the cached env instance (tests that mutate
    ``GRAFT_NETCHAOS`` between cases)."""
    global _env_chaos, _env_read
    with _env_mu:
        _env_chaos = None
        _env_read = False


def connect(chaos: Optional[NetChaos], src: str, dst: str,
            host: str, port: int, timeout: float) -> HTTPConnection:
    """The fleet's one connection factory: a plain ``HTTPConnection``
    when no chaos plan is armed (explicitly or via the env), a
    :class:`ChaosHTTPConnection` otherwise.  ``src``/``dst`` are the
    logical link endpoints (node names, or a client's own name) the
    spec's partition groups match on."""
    if chaos is None:
        chaos = env_chaos()
    if chaos is None:
        return HTTPConnection(host, int(port), timeout=timeout)
    return ChaosHTTPConnection(chaos, src, dst, host, int(port),
                               timeout=timeout)
