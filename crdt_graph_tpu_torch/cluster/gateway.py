"""The fleet gateway's wire-visible error class.

The write-forwarding gateway itself is not ported yet (ROADMAP Queue 1
item 6); ``service/http.py`` names :class:`ForwardError` in its fleet
branch, which no store of this package reaches.
"""
from __future__ import annotations


class ForwardError(Exception):
    """The document's primary could not be reached within the retry
    budget.  The HTTP layer answers 503 + Retry-After — the client
    retries once the lease table has failed the primary over (≤ one
    TTL)."""

    def __init__(self, doc_id: str, detail: str,
                 retry_after_s: int = 1):
        super().__init__(f"primary for {doc_id!r} unreachable: "
                         f"{detail}; retry in ~{retry_after_s}s")
        self.doc_id = doc_id
        self.retry_after_s = retry_after_s
