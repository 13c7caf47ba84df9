"""The package's CUDA kernels: build and binding (``build.py``) and the
launch counts of their wrappers.

Each wrapper (``ops.fused_resolve.plane_rows`` / ``plane_rows2``,
``ops.tour_scan.prefix_sums`` / ``ring_exclusive``,
``ops.mono_gather.monotone_gather``, and the ``*_batched`` form of
each of the first four, which merges a batch of documents) adds one to its entry in
:data:`launches` where it launches its kernel, and nowhere else — so a
run can show that a path went through the kernels.
"""
from typing import Dict

launches: Dict[str, int] = {"plane_rows": 0, "plane_rows2": 0,
                            "prefix_sums": 0, "monotone_gather": 0,
                            "ring_exclusive": 0,
                            "plane_rows_batched": 0,
                            "plane_rows2_batched": 0,
                            "prefix_sums_batched": 0,
                            "monotone_gather_batched": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
