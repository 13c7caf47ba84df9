"""The profiler's device time of host-to-device copies in the traced
sub-window, in ms, over the million operations merged in it."""


def read(rec):
    p, ops = rec.get("profile"), sum(rec["window"]["traced_ops"])
    if not p or not ops:
        return None
    h2d = sum(s for name, s in p["device_ops_s"].items()
              if name.startswith("Memcpy HtoD"))
    return h2d * 1e3 / (ops / 1e6) if h2d else None
