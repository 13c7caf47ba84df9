"""Operations of every candidate set merged in the window (a catch-up
step's base and delta; a request's ``num_ops``), over the window's
seconds, on the host's clock."""


def read(rec):
    w = rec["window"]
    return sum(w["ops"]) / w["window_s"] if w["ops"] else None
