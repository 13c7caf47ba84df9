"""The hand-written kernels' least work, and the card's peaks: the
yardstick of ``hand_kernels_roofline``.

Copied from the port's ``bench/kerneltime.py`` (``work_of``,
``bound_ms``): a kernel's bound is the larger of the bytes its function
must move at the card's memory rate and the operations it must do at its
32-bit rate, counting each input element it needs read once and each
output written once.  A batched wrapper's call (a leading document axis)
counts as its documents' unbatched calls together, so the work is the
same whichever form merges them.
"""
from __future__ import annotations

import torch

# NVIDIA H100 SXM (data sheet): HBM3 rate, and the non-tensor-core
# 32-bit rate (the fp32 figure)
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12

BATCHED = "_batched"

# the wrappers of the merge's hand kernels, each with its batched form:
# (module, function)
_FR, _TS, _MG = (f"crdt_graph_tpu_torch.ops.{m}"
                 for m in ("fused_resolve", "tour_scan", "mono_gather"))
WRAPPERS = (
    (_FR, "plane_rows"), (_FR, "plane_rows_batched"),
    (_FR, "plane_rows2"), (_FR, "plane_rows2_batched"),
    (_TS, "prefix_sums"), (_TS, "prefix_sums_batched"),
    (_MG, "monotone_gather"), (_MG, "monotone_gather_batched"),
)
# the CUDA kernels those wrappers launch (both forms), as the profiler
# names them
KERNEL_NAMES = ("plane_rows_kernel", "plane_rows2_kernel", "scan_lookback",
                "mono_gather_kernel")


def is_hand_kernel(name: str) -> bool:
    return any(k in name for k in KERNEL_NAMES)


def bound_ms(nbytes: int, nops: int = 0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, nops / INT_OPS_PER_S) * 1e3


def _index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's gather index rule: negative wraps once, then clamps."""
    i = idx.long()
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def work_of(kname: str, args) -> tuple:
    """(bytes, operations) the kernel's function must do for ``args``;
    a batched call's are the sums over its documents' slices."""
    if kname.endswith(BATCHED):
        one = kname[:-len(BATCHED)]
        docs = [work_of(one, [a[b] if isinstance(a, torch.Tensor) else a
                              for a in args])
                for b in range(args[0].shape[0])]
        return sum(w[0] for w in docs), sum(w[1] for w in docs)
    if kname in ("plane_rows", "plane_rows2"):
        plane, idx = args[0], args[1]
        r, c = plane.shape
        t = idx.shape[0]
        used = torch.unique(_index(idx, r))
        nb = 4 * t + 8 * c * t
        if kname == "plane_rows2":
            hop = plane[_index(idx, r)][:, args[2]]
            used = torch.unique(torch.cat(
                [used, hop[hop >= 0].clamp(max=r - 1)]))
            nb += 8 * c * t
        return nb + 8 * c * int(used.numel()), 0
    if kname == "prefix_sums":
        n = args[0].numel() + args[1].numel()
        return 8 * n, n
    if kname == "monotone_gather":
        vals, rid = args
        used = torch.unique(_index(rid, vals.shape[1]))
        v, t = vals.shape[0], rid.shape[0]
        return 4 * t + 4 * v * int(used.numel()) + 4 * v * t, 0
    raise KeyError(kname)


class Capture:
    """While open, every call of a hand-kernel wrapper adds its bound to
    :attr:`bound_ms` and counts to :attr:`calls` (the work is read from
    the arguments after the call, so it syncs: use it outside a timed
    window)."""

    def __init__(self):
        self.bound_ms = 0.0
        self.calls = {}
        self._saved = []

    def __enter__(self):
        import importlib
        for modname, fname in WRAPPERS:
            mod = importlib.import_module(modname)
            orig = getattr(mod, fname)

            def rec(*a, _orig=orig, _name=fname, **kw):
                out = _orig(*a, **kw)
                nb, nops = work_of(_name, a)
                self.bound_ms += bound_ms(nb, nops)
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return out
            self._saved.append((mod, fname, orig))
            setattr(mod, fname, rec)
        return self

    def __exit__(self, *exc):
        for mod, fname, orig in self._saved:
            setattr(mod, fname, orig)
        self._saved = []
