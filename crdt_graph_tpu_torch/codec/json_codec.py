"""JSON wire codec — byte-compatible with the reference format.

The wire format (CRDTree/Operation.elm:109-159):

- ``{"op": "add", "path": [...], "ts": n, "val": <value>}``
- ``{"op": "del", "path": [...]}``
- ``{"op": "batch", "ops": [...]}``
- unknown ``op`` tags decode to an empty batch — a forward-compatible no-op
  (CRDTree/Operation.elm:158-159).

This codec is the only inter-process surface of the protocol: replicas
exchange encoded operation batches, and the TPU service speaks exactly this
format so existing clients interoperate unchanged (tests/JsonTest.elm is the
golden fixture set).

Values are opaque to the protocol; callers may supply ``value_encoder`` /
``value_decoder`` to map application values to/from JSON-compatible objects
(default: identity).
"""
from __future__ import annotations

import json
from typing import Any, Callable, Optional

from ..core.operation import Add, Batch, Delete, Operation

Identity = lambda v: v  # noqa: E731


class DecodeError(ValueError):
    """Malformed operation JSON."""


def _int_field(v: Any) -> int:
    """Strict integer: the reference decoder (Decode.int) rejects floats,
    booleans and strings rather than coercing them.  Timestamps and path
    elements are further bounded to the wire's domain [0, 2^62) — see
    the inline comment on the check."""
    if isinstance(v, bool) or not isinstance(v, int):
        raise DecodeError(f"expected integer, got {v!r}")
    if not (0 <= v < (1 << 62)):
        # the wire's timestamp/path domain is [0, 2^62) — the native
        # parser's MAX_TS bound (fastcodec.cpp emit): the merge kernel's
        # int32 bit-half sort keys assume ts < 2^62 (merge._split_ts),
        # and a well-formed wire op carrying a larger timestamp would
        # silently corrupt bulk merges while the host path absorbed it
        # (a Python int past 2^63 even crashes the int64 columns with
        # OverflowError).  Both ingest paths must reject IDENTICALLY or
        # the same payload converges differently by body size.  The
        # reference's constructive domain (ts = replicaId·2^32 + counter,
        # CRDTree.elm:137; JS safe integers) sits far inside the bound.
        raise DecodeError(f"integer out of range: {v!r}")
    return v


def _int_path(v: Any) -> tuple:
    if not isinstance(v, list):
        raise DecodeError(f"expected path list, got {v!r}")
    return tuple(_int_field(p) for p in v)


def encode(op: Operation, value_encoder: Callable[[Any], Any] = Identity
           ) -> dict:
    """Operation → JSON-compatible dict."""
    if isinstance(op, Add):
        return {"op": "add", "path": list(op.path), "ts": op.ts,
                "val": value_encoder(op.value)}
    if isinstance(op, Delete):
        return {"op": "del", "path": list(op.path)}
    if isinstance(op, Batch):
        return {"op": "batch",
                "ops": [encode(o, value_encoder) for o in op.ops]}
    raise TypeError(f"not an operation: {op!r}")


def decode(obj: dict, value_decoder: Callable[[Any], Any] = Identity
           ) -> Operation:
    """JSON-compatible dict → Operation.

    Unknown ``op`` tags yield ``Batch(())`` (forward compatibility); missing
    required fields raise :class:`DecodeError`.
    """
    try:
        tag = obj["op"]
    except (TypeError, KeyError):
        raise DecodeError(f"missing 'op' tag in {obj!r}")
    if tag == "add":
        try:
            return Add(_int_field(obj["ts"]), _int_path(obj["path"]),
                       value_decoder(obj["val"]))
        except (KeyError, TypeError, ValueError) as e:
            raise DecodeError(f"malformed add: {obj!r}") from e
    if tag == "del":
        try:
            return Delete(_int_path(obj["path"]))
        except (KeyError, TypeError, ValueError) as e:
            raise DecodeError(f"malformed del: {obj!r}") from e
    if tag == "batch":
        ops = obj.get("ops")
        if not isinstance(ops, list):
            raise DecodeError(f"malformed batch: {obj!r}")
        return Batch(tuple(decode(o, value_decoder) for o in ops))
    return Batch(())


def dumps(op: Operation, value_encoder: Callable[[Any], Any] = Identity,
          **kw) -> str:
    """Operation → JSON string."""
    return json.dumps(encode(op, value_encoder), separators=(",", ":"), **kw)


def loads(text: str, value_decoder: Callable[[Any], Any] = Identity
          ) -> Operation:
    """JSON string → Operation."""
    return decode(json.loads(text), value_decoder)
