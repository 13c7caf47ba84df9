"""Scale-out of merges: the ops-axis sharded merge (``opsaxis``) and the
docs-axis batched merge (``mesh``).

The reference's XLA-partitioned ops axis (``mesh.make_mesh`` /
``sharded_materialize``), partitioned resolve (``shard``) and
multi-process helpers (``distributed``) are not ported yet.
"""
from . import mesh, opsaxis
from .mesh import (batched_materialize, doc_table, materialize_each,
                   stack_aligned, stack_packed)
from .opsaxis import AXIS, HALO, OpsAxisPart

__all__ = ["mesh", "opsaxis", "AXIS", "HALO", "OpsAxisPart",
           "batched_materialize", "doc_table", "materialize_each",
           "stack_aligned", "stack_packed"]
