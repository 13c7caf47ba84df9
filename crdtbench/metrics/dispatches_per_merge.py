"""Device ops of one audited merge of the cell's own inputs, outside the
window (``utils.chainaudit``)."""


def read(rec):
    a = rec.get("audit")
    return a["device_ops"] / max(1, a["merges"]) if a else None
