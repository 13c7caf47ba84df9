"""Native host codec: the wire JSON ⇄ packed-column parser and encoder.

``_fastcodec`` (``fastcodec.cpp``, a copy of the reference package's
source) parses reference-format JSON operation batches straight into
packed numpy columns (:func:`parse_pack`) and encodes packed columns back
into wire bytes (:func:`encode_pack`), with no per-op Python objects —
the host side of bulk ingest and egress.  It uses the CPython C API only.

It is built with ``g++`` at first use, from the source in the checkout,
into ``build/native/<hash>/`` at the repository root (listed in
``.gitignore``); the hash covers the source, the flags and the Python
ABI, so an edit rebuilds and a stale module is never loaded.  Nothing is
ever written next to the source.  The module loads by file path under
the spec name ``crdt_graph_tpu_torch.native._fastcodec``, so it coexists
in one process with the reference package's build of the same source.

As in the reference, the native layer is a host accelerator, never a
requirement: without a compiler :func:`available` is False and the
callers take the pure-Python codec.  :data:`calls` counts the native
parses and encodes, so a run can show which path its ingest took.
"""
from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..codec.packed import (DEFAULT_MAX_DEPTH, PackedOps, _bucket,
                            _depth_bucket)

SRC = Path(__file__).resolve().parent / "fastcodec.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" \
    / "native"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
SPEC_NAME = "crdt_graph_tpu_torch.native._fastcodec"

calls: Dict[str, int] = {"parse_pack": 0, "encode_pack": 0}

_mod = None
_build_error: Optional[str] = None
_lock = threading.Lock()


def reset_calls() -> None:
    for k in calls:
        calls[k] = 0


def _digest(include: str) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(include.encode())
    h.update((sysconfig.get_config_var("EXT_SUFFIX") or "").encode())
    h.update(sys.version.encode())
    h.update(SRC.read_bytes())
    return h.hexdigest()[:16]


def so_path() -> Path:
    """Where this checkout's build of the module lives (or will)."""
    include = sysconfig.get_path("include")
    return BUILD_ROOT / _digest(include) / "_fastcodec.so"


def _build(so: Path) -> None:
    include = sysconfig.get_path("include")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"_fastcodec.{os.getpid()}.so.tmp")
    cmd = ["g++", *CXX_FLAGS, f"-I{include}", str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, so)
    finally:
        if tmp.exists():
            tmp.unlink()


def load():
    """The native module, building it if needed; None if unavailable."""
    global _mod, _build_error
    with _lock:
        if _mod is not None:
            return _mod
        if _build_error is not None:
            return None
        try:
            so = so_path()
            if not so.exists():
                _build(so)
            spec = importlib.util.spec_from_file_location(SPEC_NAME,
                                                          str(so))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _mod = mod
        except Exception as e:   # missing compiler, read-only tree, …
            _build_error = f"{type(e).__name__}: {e}"
            return None
        return _mod


def available() -> bool:
    return load() is not None


def parse_pack(payload, max_depth: int = DEFAULT_MAX_DEPTH,
               capacity: Optional[int] = None) -> PackedOps:
    """Wire JSON (str/bytes) → :class:`PackedOps` via the native parser.

    Raises ``RuntimeError`` when the native module is unavailable —
    callers wanting transparent fallback use
    :func:`crdt_graph_tpu_torch.codec.packed.pack_json`.
    """
    mod = load()
    if mod is None:
        raise RuntimeError(f"native codec unavailable: {_build_error}")
    if isinstance(payload, str):
        payload = payload.encode()
    cols = mod.parse_pack(payload, max_depth)
    calls["parse_pack"] += 1
    n = cols["n"]
    cap = capacity if capacity is not None else _bucket(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < op count {n}")

    def col(name, dtype, shape=None):
        arr = np.frombuffer(cols[name], dtype=dtype)
        if shape is not None:
            arr = arr.reshape(shape)
        return arr

    kind = np.full(cap, 2, dtype=np.int8)           # KIND_PAD
    kind[:n] = col("kind", np.int8)
    # shrink the path plane to the batch's depth bucket, matching
    # packed.pack (flat logs get [N, 1])
    depth_col = col("depth", np.int32)
    width = _depth_bucket(int(depth_col.max(initial=1)), max_depth)
    out = PackedOps(
        kind=kind,
        ts=_padded(col("ts", np.int64), cap),
        parent_ts=_padded(col("parent_ts", np.int64), cap),
        anchor_ts=_padded(col("anchor_ts", np.int64), cap),
        depth=_padded(depth_col, cap),
        paths=_padded2(
            col("paths", np.int64, (n, max_depth))[:, :width].copy(), cap),
        value_ref=_padded(col("value_ref", np.int32), cap, fill=-1),
        pos=np.arange(cap, dtype=np.int32),
        values=cols["values"],
        num_ops=n,
        parent_pos=_padded(col("parent_pos", np.int32), cap, fill=-1),
        anchor_pos=_padded(col("anchor_pos", np.int32), cap, fill=-1),
        target_pos=_padded(col("target_pos", np.int32), cap, fill=-1),
        hints_vouched=True)   # the C++ parser resolves every in-batch ref
    # wire bytes come from outside this process, so the vouch above is
    # only as good as the C++ hint resolution: re-verify on the host
    # before the batch can reach the merge's exhaustive mode, and
    # REBUILD (not demote) on failure — a parser bug then costs speed
    # and a loud repair, never a silent mis-resolution.  ts_rank was
    # computed here from these very columns; only the link hints are
    # foreign.
    from ..codec.packed import rebuild_hints, verify_hints
    if not verify_hints(out, check_rank=False):
        import logging
        logging.getLogger(__name__).warning(
            "native parse_pack produced hint columns that failed the "
            "host audit; rebuilt (parser bug — please report)")
        rebuild_hints(out)
    return out


def encode_pack(p: PackedOps, start: int = 0) -> bytes:
    """:class:`PackedOps` columns → wire JSON bytes via the native
    encoder — the egress mirror of :func:`parse_pack`.  Emits
    ``{"op":"batch","ops":[...]}`` for rows ``[start, num_ops)``,
    byte-compatible with ``json_codec.dumps`` of the same ops.  Raises
    ``ValueError`` for a value the native encoder cannot write (the
    callers then take the Python path) and ``RuntimeError`` when the
    native module is unavailable.
    """
    mod = load()
    if mod is None:
        raise RuntimeError(f"native codec unavailable: {_build_error}")
    n = p.num_ops
    # suffix slices of contiguous columns stay views (a small delta pull
    # costs O(delta)); values is passed whole (value_ref indexes it)
    out = mod.encode_pack(
        np.ascontiguousarray(p.kind[start:n], dtype=np.int8),
        np.ascontiguousarray(p.ts[start:n], dtype=np.int64),
        np.ascontiguousarray(p.depth[start:n], dtype=np.int32),
        np.ascontiguousarray(p.paths[start:n], dtype=np.int64),
        np.ascontiguousarray(p.value_ref[start:n], dtype=np.int32),
        p.values, 0, n - start, p.paths.shape[1])
    calls["encode_pack"] += 1
    return out


def _padded(a: np.ndarray, cap: int, fill=0) -> np.ndarray:
    out = np.full(cap, fill, dtype=a.dtype)
    out[:a.shape[0]] = a
    return out


def _padded2(a: np.ndarray, cap: int) -> np.ndarray:
    out = np.zeros((cap, a.shape[1]), dtype=a.dtype)
    out[:a.shape[0]] = a
    return out
