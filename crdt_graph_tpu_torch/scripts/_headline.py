"""What the headline entry points share: the device a run takes, the
tag its output carries, where that output goes, the count of the
commits its flight recorders sampled, and what a missed speed gate
raises."""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path
from typing import List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "build" / "headline"


class SpeedGateFailed(AssertionError):
    """A speed gate missed its threshold (a ratio the reference set on its
    own hardware).  Raised after the output is written and after every
    correctness check of the run has passed, so a caller that reports
    speed gates as data catches this and nothing else."""


def speed_gate(out: dict, *measured) -> None:
    """Raise :class:`SpeedGateFailed` with ``measured`` when
    ``out["gate"]["pass"]`` is false."""
    if not out["gate"]["pass"]:
        raise SpeedGateFailed(out["gate"]["want"], *measured)


def out_path(name: str) -> str:
    """The default output of entry point ``name``:
    ``build/headline/BENCH_<NAME>.json`` under the checkout."""
    return str(OUT_DIR / f"BENCH_{name.upper()}.json")


def resolve(device=None):
    """The device a run takes: the card unless ``device`` names another;
    with no card and no ``device`` this raises (``merge.resolve_device``)."""
    from ..ops.merge import resolve_device
    return resolve_device(device)


def device_block(dev) -> dict:
    """``{name, power_limit}`` of the device a run took: the card's as
    ``nvidia-smi`` gives them, or ``{"name": "cpu", "power_limit":
    None}`` for the plain path."""
    import torch
    dev = torch.device(dev)
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    from ..bench.kerneltime import card_line
    name, _, power = card_line().rpartition(", ")
    return {"name": name, "power_limit": power}


def platform_tag(block: dict) -> str:
    """The tag that stands where the reference wrote ``"cpu"``: the
    card's name and power limit, or ``"cpu"``."""
    if block["power_limit"] is None:
        return block["name"]
    return f"{block['name']}, {block['power_limit']}"


def audit_mark() -> dict:
    """The process's flight-audit tally now (``obs.flight.audit_tally``)."""
    from ..obs import flight
    return flight.audit_tally()


def audit_since(mark: dict) -> dict:
    """``{sampled, failures}``: the commits every flight recorder of this
    process sampled (a chain audit of its merge) since ``mark``, and
    those over budget — sampling is on by default, so a reader can tell
    a run with sampled commits from a plain one."""
    now = audit_mark()
    return {k: now[k] - mark[k] for k in now}


def write(out: dict, path: str) -> None:
    """``out`` as indented JSON at ``path`` (its directory made)."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


def split_device(argv: List[str]) -> Tuple[Optional[str], List[str]]:
    """``(device, the other arguments)`` of a command line that may
    carry ``--device NAME`` (or ``--device=NAME``) anywhere.  Exits 2
    with the resolver's message when no device is named and no card is
    present, before anything runs or is written."""
    device, rest = None, []
    it = iter(argv)
    for a in it:
        if a == "--device":
            device = next(it, None)
            if device is None:
                raise SystemExit("--device needs a value (cpu, cuda)")
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    try:
        resolve(device)
    except RuntimeError as e:
        print(f"{Path(sys.argv[0]).stem}: {e}", file=sys.stderr)
        raise SystemExit(2)
    return device, rest
