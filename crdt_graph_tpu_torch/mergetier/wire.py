"""The ``POST /merge`` wire codec: packed-npz candidate sets out,
npz-serialized :class:`~crdt_graph_tpu_torch.ops.merge.NodeTable` frames
back, end-to-end digests on both legs.

Request body — exactly the packed-checkpoint npz format
(``engine.write_packed_npz`` / ``codec.packed.load_packed_npz``: the
same wire unit snapshots and cold segments already ride), carrying the
document's FULL candidate column set (current log ∪ delta, the output
of ``TpuTree.prepare_packed``) plus meta:

- ``num_ops``/``hints_vouched`` — the loader contract;
- ``doc_id``, ``num_new`` (the delta's row count — the suffix whose
  statuses the front-end commits), ``capacity`` (the sender's capacity
  bucket, restored on load so the worker's shared alignment is
  computed over the same capacities the senders hold);
- ``input_digest`` — sha1 over the real rows of every column; the
  worker echoes it so a response can never be applied to the wrong
  request.

Response body — ``np.savez`` of the table's arrays under ``t_*`` keys
plus meta: ``shared_capacity`` (what the front-end re-aligns its own
candidate columns to before committing), ``width`` (the launch's
achieved cross-doc batch width — the headline number), the echoed
``input_digest``, and ``frame_digest`` — sha1 over the table arrays in
canonical field order, recomputed by the front-end on decode.  A
mismatch anywhere raises :class:`MergeWireError`, which the client
turns into a local-merge fallback (never a failed write).
"""
from __future__ import annotations

import hashlib
import io
import json
from typing import Dict, Tuple

import numpy as np

from ..codec import packed as packed_mod
from ..codec.packed import PackedOps
from ..ops.merge import NodeTable
from ..utils import profiling

FORMAT_VERSION = 1

# NodeTable fields in canonical wire order (digest + savez key order)
_TABLE_FIELDS = ("ts", "parent", "depth", "value_ref", "paths",
                 "exists", "tombstone", "dead", "visible", "doc_index",
                 "order", "visible_order", "num_nodes", "num_visible",
                 "status")


class MergeWireError(ValueError):
    """A merge-tier wire body failed to decode or verify (truncated,
    corrupt, wrong version, digest mismatch).  The client maps this to
    a counted local-merge fallback; the worker answers 400."""


@profiling.span("mergetier.digest")
def _sha1_arrays(arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def request_digest(p: PackedOps) -> str:
    """Digest over the REAL rows of every request column (capacity
    padding never hits the wire, so it never enters the digest)."""
    n = p.num_ops
    cols = [np.asarray(v)[:n] for _, v in sorted(p.arrays().items())]
    cols.append(np.frombuffer(
        json.dumps(p.values).encode(), np.uint8))
    return _sha1_arrays(cols)


def frame_digest(table: NodeTable) -> str:
    """Digest over the materialized frame in canonical field order —
    computed by the worker on the launch result and recomputed by the
    front-end on the decoded arrays (transport integrity, both hops)."""
    return _sha1_arrays(getattr(table, f) for f in _TABLE_FIELDS)


def encode_request(doc_id: str, p: PackedOps, num_new: int,
                   trace_meta: Dict = None) -> bytes:
    """Pack one document's prepared candidate set for ``POST /merge``.
    ``trace_meta`` (fleet tracing: the commit's trace ids +
    the sender's ``X-Span-Ctx`` twin) rides as one extra meta key and
    is omitted entirely when None — with ``GRAFT_FLEETTRACE=0`` the
    request bytes carry no trace key."""
    from .. import engine as engine_mod
    meta = {
        "fmt": FORMAT_VERSION,
        "num_ops": int(p.num_ops),
        "hints_vouched": bool(p.hints_vouched),
        "doc_id": str(doc_id),
        "num_new": int(num_new),
        "capacity": int(p.capacity),
        "input_digest": request_digest(p),
    }
    if trace_meta is not None:
        meta["trace"] = trace_meta
    buf = io.BytesIO()
    engine_mod.write_packed_npz(buf, p, meta, compress=False)
    body = buf.getvalue()
    profiling.count("mergetier.wire_bytes", len(body))
    return body


def decode_request(body: bytes) -> Tuple[PackedOps, Dict]:
    """Worker-side decode: the loader's typed failures become
    :class:`MergeWireError`; the sender's capacity is restored so the
    batch's shared alignment matches what the front-ends hold."""
    from ..core.errors import CheckpointError
    try:
        p, meta = packed_mod.load_packed_npz(io.BytesIO(body))
    except CheckpointError as e:
        raise MergeWireError(f"merge request unreadable: {e}") from e
    if meta.get("fmt") != FORMAT_VERSION:
        raise MergeWireError(
            f"merge request format {meta.get('fmt')!r} "
            f"(worker speaks {FORMAT_VERSION})")
    num_new = meta.get("num_new")
    if not isinstance(num_new, int) or isinstance(num_new, bool) \
            or not (0 < num_new <= p.num_ops):
        raise MergeWireError(
            f"num_new {num_new!r} inconsistent with {p.num_ops} rows")
    cap = meta.get("capacity")
    if isinstance(cap, int) and not isinstance(cap, bool) \
            and cap >= p.num_ops:
        p = packed_mod.with_capacity(p, cap)
    if meta.get("input_digest") != request_digest(p):
        raise MergeWireError("merge request digest mismatch")
    return p, meta


def encode_response(table: NodeTable, shared_capacity: int, width: int,
                    input_digest: str, extra: Dict = None) -> bytes:
    """Worker-side encode of one document's slice of the batched
    launch (host numpy by now: the worker reads its epoch back once).
    ``extra`` (the worker's queue/launch sub-stage timings — echoed
    only when the request carried trace context) merges into meta;
    None keeps the timings out of the response bytes."""
    arrays = {f"t_{f}": np.asarray(getattr(table, f))
              for f in _TABLE_FIELDS}
    meta = {"fmt": FORMAT_VERSION,
            "shared_capacity": int(shared_capacity),
            "width": int(width),
            "input_digest": str(input_digest),
            "frame_digest": frame_digest(table)}
    if extra:
        meta.update(extra)
    buf = io.BytesIO()
    np.savez(buf, meta=np.frombuffer(json.dumps(meta).encode(),
                                     np.uint8), **arrays)
    body = buf.getvalue()
    profiling.count("mergetier.wire_bytes", len(body))
    return body


def decode_response(body: bytes) -> Tuple[NodeTable, Dict]:
    """Front-end decode + verify: rebuild the NodeTable from the
    ``t_*`` arrays and recompute ``frame_digest`` — a corrupt or
    truncated frame must fall back locally, never park a wrong table."""
    import struct
    import zipfile
    import zlib
    try:
        z = np.load(io.BytesIO(body))
        meta = json.loads(bytes(z["meta"]).decode())
        table = NodeTable(**{f: z[f"t_{f}"] for f in _TABLE_FIELDS})
    except (OSError, zipfile.BadZipFile, zlib.error, KeyError,
            IndexError, ValueError, TypeError, EOFError,
            struct.error) as e:
        raise MergeWireError(
            f"merge response unreadable: {type(e).__name__}: {e}") from e
    if meta.get("fmt") != FORMAT_VERSION:
        raise MergeWireError(
            f"merge response format {meta.get('fmt')!r}")
    if meta.get("frame_digest") != frame_digest(table):
        raise MergeWireError("merge response frame digest mismatch")
    cap = meta.get("shared_capacity")
    if not isinstance(cap, int) or isinstance(cap, bool) \
            or int(table.ts.shape[0]) != cap + 2:
        raise MergeWireError(
            f"frame rows {int(table.ts.shape[0])} inconsistent with "
            f"shared capacity {cap!r}")
    return table, meta
