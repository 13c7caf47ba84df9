"""Wire service: the server side of the reference's deployment model,
with every served document merging on the card."""
from ..serve import ServingEngine
from .http import make_server, serve
from .store import Document, DocumentStore

__all__ = ["Document", "DocumentStore", "ServingEngine", "make_server",
           "serve"]
