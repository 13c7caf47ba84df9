"""Unified observability: end-to-end commit tracing, the flight
recorder, and the Prometheus/JSON exposition surface.

- :mod:`~crdt_graph_tpu_torch.obs.trace` — a ``trace_id`` minted at HTTP
  admission rides the write ticket through the coalescing scheduler,
  chunked merges, and snapshot publish; a :class:`CommitTrace` collects
  the per-commit stage breakdown as the scheduler works.
- :mod:`~crdt_graph_tpu_torch.obs.flight` — a bounded ring of per-commit
  records with automatic JSONL dumps on SLO breach or engine exception
  (the post-mortem survivor; chain-audit sampling is not ported).
- :mod:`~crdt_graph_tpu_torch.obs.prom` — one scrape surface
  (``GET /metrics/prom``) merging store counters, scheduler histograms
  (bucket bounds, not just quantiles), the span registry, and flight
  gauges; plus the enriched ``GET /debug/flight`` JSON.
- :mod:`~crdt_graph_tpu_torch.obs.oracle` — the online session-guarantee
  oracle: read-your-writes / monotonic-read / convergence checks over
  the trace+flight stream, with seeded fault injection
  (``GRAFT_ORACLE_FAULT``) proving the detection path.
- :mod:`~crdt_graph_tpu_torch.obs.fleettrace` — fleet-wide causal
  tracing: per-node span rings, ``X-Span-Ctx`` on forwarded and
  offloaded requests, ``X-Trace-Frontier`` on anti-entropy windows.
- :mod:`~crdt_graph_tpu_torch.obs.ledger` — the write-to-visibility
  ledger (ack, durable, delivered, visible at each replica).
- :mod:`~crdt_graph_tpu_torch.obs.canary` — the fleet node's continuous
  canary write/read prober.

See docs/OBSERVABILITY.md for the lifecycle, the record schema, and
the dump-trigger contract.
"""
from .flight import CommitRecord, FlightRecorder, get_default_recorder
from .oracle import FaultInjector, SessionOracle
from .trace import (COMMIT_SEQ_HEADER, SESSION_HEADER, SNAP_FP_HEADER,
                    TRACE_HEADER, CommitTrace, ensure_session_id,
                    ensure_trace_id, mint_trace_id)

__all__ = [
    "COMMIT_SEQ_HEADER",
    "SESSION_HEADER",
    "SNAP_FP_HEADER",
    "TRACE_HEADER",
    "CommitRecord",
    "CommitTrace",
    "FaultInjector",
    "FlightRecorder",
    "SessionOracle",
    "ensure_session_id",
    "ensure_trace_id",
    "get_default_recorder",
    "mint_trace_id",
]
