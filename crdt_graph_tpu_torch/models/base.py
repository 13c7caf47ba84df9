"""Shared plumbing for application document models: engine selection and
the replication surface (broadcast delta, pull anti-entropy), so every
model speaks the same sync protocol without re-implementing it."""
from __future__ import annotations

from ..core.operation import Operation


class ReplicatedModel:
    """Engine-backed replicated document base.

    Subclasses provide the domain editing surface; this base owns the
    engine handle (``"tpu"``: the replica engine ``TpuTree``, whose bulk
    merges run on ``device`` — the card unless the caller names another,
    raising without one; ``"oracle"``: the persistent state machine
    ``core.tree``) and the replication methods shared by all models.
    """

    def __init__(self, replica: int, engine: str = "tpu", device=None):
        if engine == "tpu":
            from .. import engine as tpu_engine
            self._t = tpu_engine.init(replica, device=device)
        elif engine == "oracle":
            from ..core import tree as oracle_mod
            self._t = oracle_mod.init(replica)
        else:
            raise ValueError(f"unknown engine {engine!r}")
        self._engine = engine

    @property
    def replica_id(self) -> int:
        return self._t.replica_id

    @property
    def last_operation(self) -> Operation:
        return self._t.last_operation

    def apply(self, delta: Operation):
        """Merge a remote delta (cursor-stable, idempotent)."""
        self._t = self._t.apply(delta)
        return self

    def operations_since(self, ts: int) -> Operation:
        return self._t.operations_since(ts)

    def last_replica_timestamp(self, replica: int) -> int:
        return self._t.last_replica_timestamp(replica)

    def sync_from(self, peer: "ReplicatedModel"):
        """Pull-based anti-entropy: fetch everything newer than the last
        timestamp seen from the peer."""
        since = self.last_replica_timestamp(peer.replica_id)
        return self.apply(peer.operations_since(since))
