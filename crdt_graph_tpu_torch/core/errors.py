"""Error taxonomy shared by every engine.

The node kernel signals three conditions (reference Internal/Node.elm:35-38):

- ``AlreadyApplied`` — the operation is a duplicate or targets a tombstone;
  the replica layer absorbs it as a success-no-op (CRDTree.elm:318-319).
  This is the idempotence contract: duplicate delivery is normal.
- ``NotFound`` — the anchor/target is missing; surfaces as
  ``OperationFailedError`` at the replica layer (CRDTree.elm:324-325),
  typically a causality gap the application retries after a wider sync.
- ``InvalidPath`` — the path is empty or an intermediate node is missing;
  surfaces as ``InvalidPathError`` (CRDTree.elm:321-322).
"""
from __future__ import annotations


class CRDTError(Exception):
    """Base class for all errors raised by this framework."""


class NodeError(CRDTError):
    """Base class for node-kernel level errors."""


class AlreadyApplied(NodeError):
    """Operation already took effect (duplicate add, delete of tombstone,
    or edit under a deleted branch)."""


class NotFound(NodeError):
    """Anchor or delete target missing from its branch."""


class InvalidPath(NodeError):
    """Empty path or missing intermediate node along the path."""


class InvalidPathError(CRDTError):
    """Replica-level: an operation carried an invalid path."""


class OperationFailedError(CRDTError):
    """Replica-level: an operation's target was not found."""

    def __init__(self, operation) -> None:
        super().__init__(f"operation failed: {operation!r}")
        self.operation = operation


class CheckpointError(CRDTError):
    """A checkpoint/snapshot byte stream could not be parsed.

    ``restore_packed`` translates the zoo of low-level failures a corrupt
    or truncated npz produces (BadZipFile, zlib.error, KeyError on a
    missing member, struct/ValueError on malformed metadata, …) into this
    one typed error so servers and bootstrap clients can answer "bad
    snapshot" without matching on zipfile internals.  Payload corruption
    inside intact zip members is caught by the per-member CRC; flipped
    bits in zip padding that change nothing decode to the original tree.
    """
