"""Disaggregated merge tier: pooled cross-document batched merge
workers serving thin replica front-ends (docs/MERGETIER.md).

Serving front-ends keep admission, acks, the WAL, the read cache, watch
and anti-entropy; the merges of giant and coalescible rounds ship to a
pooled **merge worker** that owns the card, accumulates candidate sets
from the WHOLE fleet's traffic inside a ``GRAFT_MERGETIER_BATCH_MS``
linger window, and merges each window's documents as one batched merge
over a document axis on the card (``parallel.mesh.stack_aligned`` +
``parallel.mesh.batched_materialize``).

- :mod:`.wire` — the packed-npz ``POST /merge`` request/response codec
  with end-to-end digests.
- :mod:`.worker` — the merge worker: linger batcher + one batched merge
  per epoch on its device; serves ``/merge`` behind ``service.http`` or
  is called directly (the in-process transport).
- :mod:`.client` — the front-end's client: route thresholds, worker
  selection, per-worker circuit breakers, the end-to-end budget, the
  dry-check, and the fallback ladder (any failure → the same merge on
  the front-end's own device; ``GRAFT_MERGETIER=0`` is the kill
  switch).

Worker registration rides the cluster lease KV under the ring-
independent ``mergeworker/`` prefix (cluster/mergepool.py) — workers
are a pooled resource, never ring members.
"""
from .client import MergeTierClient, tier_enabled, route_min_ops
from .wire import MergeWireError
from .worker import MergeWorker

__all__ = ["MergeTierClient", "MergeWorker", "MergeWireError",
           "tier_enabled", "route_min_ops"]
