"""The control of the comparison that decides ``correct``.

    python3 -m crdtbench.control --workload <name> --seeds <n> [<n> ...]

For each seed, builds the cell's inputs at its own size and, for every
answer a run's check compares, puts the control in the program's place:
the plain reference with one stated guarantee broken (concurrent
siblings in arrival order instead of RGA's timestamp order, so the
merged tree depends on the delivery order).  Prints, per seed, the
mismatch counts the check would read, one JSON line a seed; a sound
comparison reads them above its limits (0).  Needs no card; the
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import drivers
from .reference import check as check_mod
from .reference import rga
from .run import HERE, load_cell


def readings(workload: str, seed: int, root=None, adjust=None) -> dict:
    spec = load_cell(Path(root) if root else HERE.parent, workload)
    if adjust is not None:
        adjust(spec["config"], spec["traffic"])
    drv = drivers.load(spec["traffic"]["driver"])(
        spec["config"], spec["traffic"], seed, None, False)
    drv.inputs()
    counts = []
    for _, cols in drv.checked():
        n = int(cols["ts"].shape[0])
        got = rga.converge(cols["kind"], cols["ts"], cols["depth"],
                           cols["paths"], n, sibling_rule="arrival")
        counts.append(check_mod.judge(
            {"order_ts": got["order_ts"], "order_depth": got["order_depth"],
             "order_parent_ts": got["order_parent_ts"],
             "status": got["status"]}, cols, n))
    return {"workload": workload, "seed": seed, "answers": len(counts),
            **check_mod.add_up(counts)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="crdtbench.control",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
