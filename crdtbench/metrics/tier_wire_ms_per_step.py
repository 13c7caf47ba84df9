"""Milliseconds a traced remote merge spends in the merge tier's wire
codec, both legs and both ends (``mergetier.encode_request``,
``decode_request``, ``encode_response``, ``decode_response``: npz
bodies and their sha1 digests), from the program's span log."""

from crdtbench import spanlog

ROOT = "mergetier.merge_one"
CODEC = {f"mergetier.{s}" for s in ("encode_request", "decode_request",
                                    "encode_response", "decode_response")}


def read(rec):
    got = spanlog.steps(rec, ROOT)
    if got is None:
        return None
    recs, steps = got
    return spanlog.ms(recs, lambda r: r["name"] in CODEC) / steps
