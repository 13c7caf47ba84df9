"""Environment switches, read at call time.

Copies of the reference package's ``flag_on`` and ``env_int``, so the
port reads the same ``GRAFT_*`` names with the same rules (the op log's
``GRAFT_OPLOG_*`` sizing knobs among them).  The reference's CPU-mesh
helpers are left out: they pin a JAX process to its host platform, which
this package never starts.
"""
from __future__ import annotations

import os


def flag_on(name: str, default: str = "1") -> bool:
    """One boolean env flag, read at call time and logged (the merge
    reads ``GRAFT_CROWD_HINTS``).  ``"0"``, ``"off"`` and the empty string
    mean OFF."""
    import logging
    on = os.environ.get(name, default).lower() not in ("0", "off", "")
    logging.getLogger("crdt_graph_tpu_torch.flags").info(
        "call-time %s=%d", name, on)
    return on


def env_int(name: str, default: int) -> int:
    """One integer env knob, falling back to ``default`` on absence OR
    malformed content, so a typo'd value degrades to the documented
    default instead of crashing process start."""
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default
