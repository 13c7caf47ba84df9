"""Timestamp scheme: ``ts = replica_id * 2**32 + counter``.

A replica's logical clock is a single integer whose high bits carry the
replica id and whose low 32 bits carry a per-replica operation counter
(reference: CRDTree/Timestamp.elm:16-18, CRDTree.elm:33-35,137).  The clock
advances only for operations originated by the local replica
(CRDTree.elm:337-343), so timestamps are per-replica sequence numbers — a
vector clock entry — not a Lamport clock.

Because every operation's timestamp embeds its origin, timestamps are
globally unique, which makes them usable as node identities and as the final
tie-break of every deterministic sort in the TPU kernels.
"""

REPLICA_SHIFT = 2**32


def replica_id(timestamp: int) -> int:
    """Extract the replica id from a timestamp (CRDTree/Timestamp.elm:16-18)."""
    return timestamp // REPLICA_SHIFT


def counter(timestamp: int) -> int:
    """The per-replica sequence number in the low 32 bits."""
    return timestamp % REPLICA_SHIFT


MAX_REPLICA = 1 << 30


def make(replica: int, count: int) -> int:
    """Compose a timestamp from a replica id and a counter.

    Replica ids are bounded to [0, 2^30): the wire's integer domain is
    [0, 2^62) (json_codec._int_field / fastcodec int64_field — the merge
    kernel's int32 bit-half sort keys need ts < 2^62), so a larger id
    would mint timestamps every peer rejects at decode — the bound is
    enforced HERE, at the constructive source, so the failure surfaces
    at init instead of as remote decode errors."""
    if not (0 <= replica < MAX_REPLICA):
        raise ValueError(
            f"replica id {replica!r} outside [0, 2**30): timestamps "
            f"would leave the wire's [0, 2**62) integer domain")
    return replica * REPLICA_SHIFT + count
