"""Scale-out of one merge: the ops-axis sharded merge (``opsaxis``).

The reference's docs-axis batching (``mesh``), partitioned resolve
(``shard``) and multi-process helpers (``distributed``) are not ported
yet.
"""
from . import opsaxis
from .opsaxis import AXIS, HALO, OpsAxisPart

__all__ = ["opsaxis", "AXIS", "HALO", "OpsAxisPart"]
