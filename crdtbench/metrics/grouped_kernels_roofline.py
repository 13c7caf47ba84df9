"""The hand-written kernels' share of their roofline in a grouped cell,
whose one batched merge a step launches them in their batched forms on
``[B, N]`` (a batched call's work is its documents' unbatched work,
``crdtbench.kernelwork``): read as ``hand_kernels_roofline`` reads the
catch-up cell's, in %."""
from crdtbench import run


def read(rec):
    return run.read_metric("hand_kernels_roofline", rec)
