"""Environment switches, read at call time.

A copy of the reference package's ``flag_on``, so the port reads the
same ``GRAFT_*`` switch names with the same rule.  The reference's other
helpers are left out: its integer knobs belong to the serving stack, and
its CPU-mesh helpers pin a JAX process to its host platform, which this
package never starts.
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
