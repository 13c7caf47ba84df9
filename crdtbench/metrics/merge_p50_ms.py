"""The median of every step of the window, each timed from the call
until its result is on the host, from the raw samples."""
import statistics


def read(rec):
    lat = rec["window"]["latencies_ms"]
    return statistics.median(lat) if lat else None
