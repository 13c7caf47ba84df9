"""The sequential oracle (``CRDTree``) and the operation model — copies
of the reference package's ``core``, so the port holds its engine to
the same oracle with no JAX installed."""
from . import node, operation, timestamp
from .errors import (AlreadyApplied, CRDTError, InvalidPath, InvalidPathError,
                     NotFound, OperationFailedError)
from .operation import Add, Batch, Delete, Operation
from .tree import CRDTree, DONE, TAKE, init
