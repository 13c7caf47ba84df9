"""The share of the traced window's wall time in which nothing (no
kernel, no copy, no fill) ran on the card, in %."""


def read(rec):
    p = rec.get("profile")
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"]) if p else None
