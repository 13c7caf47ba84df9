"""crdt_graph_tpu_torch — the replicated-tree CRDT merge in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``crdt_graph_tpu`` (the JAX reference, which stays as it is):
the same packed op batch goes through ``ops.merge.materialize`` and comes
back as the same ``NodeTable``, field for field.  This package imports
``torch`` and ``numpy`` only — never ``jax`` and nothing of the reference
package; the modules it needs from there are copies (``core``, ``codec``,
``bench.workloads``, ``utils.hostenv``).

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``), where each kernel's plain PyTorch twin runs instead.
``init(replica)`` builds a replica engine (``engine.TpuTree``) whose bulk
merges run on the card; ``CRDTree`` is the sequential oracle.
"""
from .core import timestamp
from .core.errors import (AlreadyApplied, CRDTError, CheckpointError,
                          InvalidPathError, NotFound, OperationFailedError)
from .core.operation import Add, Batch, Delete, Operation
from .core.tree import CRDTree, DONE, TAKE
from .engine import TpuTree, init

__version__ = "0.1.0"

__all__ = [
    "Add", "AlreadyApplied", "Batch", "CRDTError", "CRDTree",
    "CheckpointError", "DONE", "Delete", "InvalidPathError", "NotFound",
    "Operation", "OperationFailedError", "TAKE", "TpuTree", "init",
    "timestamp",
]
