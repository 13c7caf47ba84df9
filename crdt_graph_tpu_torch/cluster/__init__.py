"""Replica fleet: consistent-hash routing, replica-id leases, and
background anti-entropy between serving processes (docs/CLUSTER.md).

The reference delegates distribution to "a coordinating server that
assigns replica ids" plus an ``operationsSince`` anti-entropy contract
(PAPER.md survey §1); this package is that coordinator made real, as a
fleet of peers instead of a privileged process:

- :mod:`~crdt_graph_tpu_torch.cluster.kv` — the small coordination
  key-value store everything else is built on (in-process for tests,
  file-backed for localhost fleets, adapter-ready for etcd in a pod);
- :mod:`~crdt_graph_tpu_torch.cluster.ring` — consistent-hash doc→server
  routing over the live membership, with deterministic rebalancing;
- :mod:`~crdt_graph_tpu_torch.cluster.lease` — TTL replica-id leases with
  fencing tokens and crash-safe re-acquisition (membership IS the
  lease table);
- :mod:`~crdt_graph_tpu_torch.cluster.antientropy` — the background sync
  daemon: peers exchange packed ``operationsSince`` windows with
  per-peer high-water marks, delta caps, and backoff + jitter;
- :mod:`~crdt_graph_tpu_torch.cluster.gateway` — the store the HTTP layer
  serves: any server accepts any request, writes forward to the doc's
  primary, reads serve the LOCAL replica snapshot with honest
  ``X-Replica-*`` / ``X-State-Fingerprint`` / ``X-Ae-Lag-Seconds``
  headers;
- :mod:`~crdt_graph_tpu_torch.cluster.netchaos` — deterministic network
  fault injection for every inter-node client path: seeded drop /
  delay / throttle / cut / dup faults and scheduled partition
  matrices (``GRAFT_NETCHAOS``), so a partition test is a replayable
  artifact;
- :mod:`~crdt_graph_tpu_torch.cluster.pool` — persistent keep-alive
  connection pooling for every one of those client paths, threaded
  through the ``netchaos.connect`` factory so chaos bites pooled
  traffic exactly as it bit per-request connections (a cut poisons
  exactly the pooled connection it hit);
- :mod:`~crdt_graph_tpu_torch.cluster.mergepool` — the merge-worker
  registry under the ring-independent ``mergeworker/`` prefix
  (mergetier/).

Run one node on the card: ``python -m crdt_graph_tpu_torch.cluster
--name n0 --kv-dir /tmp/fleet --port 8931`` (``--cpu`` runs its merges
on the host CPU through the kernels' plain twins).
"""
from .antientropy import AntiEntropy
from .gateway import ClusterNode, FleetServer, ForwardError
from .kv import FileKV, MemoryKV
from .lease import Lease, LeaseError, LeaseLost, LeaseService
from .netchaos import ChaosHTTPConnection, NetChaos, NetChaosSpecError
from .pool import ConnectionPool
from .ring import HashRing

__all__ = ["AntiEntropy", "ChaosHTTPConnection", "ClusterNode",
           "ConnectionPool", "FileKV", "FleetServer",
           "ForwardError", "HashRing", "Lease", "LeaseError",
           "LeaseLost", "LeaseService", "MemoryKV", "NetChaos",
           "NetChaosSpecError"]
