"""Build the package's CUDA kernels with ``nvcc`` and bind them with ctypes.

Every ``csrc/*.cu`` compiles for ``sm_90a`` into an object of its own —
one ``nvcc`` per source, all started together — and the objects link
into one shared library with a plain C interface.  Each C entry point
takes device pointers, sizes and the CUDA stream, launches its kernel,
and returns ``cudaGetLastError()``; :func:`check` turns a nonzero code
into an exception, so a refused launch is never silent.

The build runs at first use, from the sources in the checkout, into
``build/kernels/<hash>/`` at the repository root (listed in
``.gitignore``); the hash covers every source and the flags, so an edit
rebuilds and a stale library is never loaded.  Nothing here runs when the
package is imported, and nothing runs on a machine without a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" \
    / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
ptxas_log: str = ""

_VP, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# C signatures of the entry points (csrc/*.cu)
SIGNATURES = {
    # plane, R, C, idx, T, out, out2 (NULL = one hop), hop_col, stream
    "crdt_plane_rows": [_VP, _I64, _I64, _VP, _I64, _VP, _VP, _INT, _VP],
    # plane, B, R, C, idx, T, out, out2, hop_col, stream (B documents)
    "crdt_plane_rows_batched": [_VP, _I64, _I64, _I64, _VP, _I64, _VP, _VP,
                                _INT, _VP],
    # C, aligned16, plan (int[4]: kernel 1's launch geometry)
    "crdt_plane_rows_plan": [_I64, _INT, _VP],
    # boundary, out_b, T, weights, out_w, Kw, M, scratch, scratch_len
    # (8-byte words), stream
    "crdt_prefix_sums": [_VP, _VP, _I64, _VP, _VP, _I64, _I64, _VP, _I64,
                         _VP],
    # boundary, out_b, B, T, weights, out_w, Kw, M, scratch, scratch_len,
    # stream (B documents)
    "crdt_prefix_sums_batched": [_VP, _VP, _I64, _I64, _VP, _VP, _I64, _I64,
                                 _VP, _I64, _VP],
    # values, V, R, rid, T, out, stream
    "crdt_monotone_gather": [_VP, _I64, _I64, _VP, _I64, _VP, _VP],
    # values, B, V, R, rid, T, out, stream (B documents)
    "crdt_monotone_gather_batched": [_VP, _I64, _I64, _I64, _VP, _I64, _VP,
                                     _VP],
    # src pointers, dst pointers (host arrays of k), k, L, op, stream
    "crdt_ring_exclusive": [_VP, _VP, _INT, _I64, _INT, _VP],
    # device, peer
    "crdt_enable_peer_access": [_INT, _INT],
}


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch."""


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> None:
    global ptxas_log
    nvcc = nvcc_path()
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs, failed = [], []
    for src, obj, p in procs:
        out = p.communicate()[0].decode(errors="replace")
        logs.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    ptxas_log = "\n".join(logs)
    if failed:
        raise KernelError(f"nvcc failed on {failed}:\n{ptxas_log}")
    tmp = out_dir / "libcrdt_kernels.so.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp)] +
        [str(o) for _, o, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode != 0:
        raise KernelError("link failed:\n" +
                          link.stdout.decode(errors="replace"))
    os.replace(tmp, out_dir / "libcrdt_kernels.so")


def load() -> ctypes.CDLL:
    """The bound kernel library, built on first call (under a lock; once
    it is loaded, without one).  Its entry points are attributes that
    ctypes looked up, and typed, once."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = BUILD_ROOT / _digest()
        so = out_dir / "libcrdt_kernels.so"
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            _compile(out_dir)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(code: int, name: str) -> None:
    """Raise when a C entry point returned a nonzero ``cudaError_t``."""
    if code != 0:
        raise KernelError(f"{name}: CUDA error {code}")


def stream_ptr(device) -> int:
    """The current PyTorch CUDA stream of ``device``, as a raw handle
    (PyTorch's raw-handle query: it makes no ``Stream`` object)."""
    import torch
    idx = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if idx is None else idx)
