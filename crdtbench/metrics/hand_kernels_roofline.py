"""The hand-written kernels' share of their roofline over the window:
the sum of each launch's bound (``crdtbench.kernelwork``: bytes at the
H100's memory rate, operations at its 32-bit rate) over the profiler's
device time of those kernels in the traced sub-window, in %.  Launch
shapes come from one captured step of each input the sub-window merged,
times the steps it had."""
from crdtbench import kernelwork


def read(rec):
    prof, bound = rec.get("profile"), rec.get("kernel_bound_ms")
    if not prof or not bound:
        return None
    dev_s = sum(s for name, s in prof["device_ops_s"].items()
                if kernelwork.is_hand_kernel(name))
    return 100.0 * (bound / 1e3) / dev_s if dev_s else None
