"""Application-layer document models built on the replica engines."""
from .base import ReplicatedModel
from .outline import OutlineDoc
from .text import TextBuffer

__all__ = ["ReplicatedModel", "TextBuffer", "OutlineDoc"]
