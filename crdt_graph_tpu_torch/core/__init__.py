"""Operation model shared with the reference package (copies)."""
from . import operation, timestamp
from .errors import (AlreadyApplied, CRDTError, InvalidPath, InvalidPathError,
                     NotFound, OperationFailedError)
from .operation import Add, Batch, Delete, Operation
