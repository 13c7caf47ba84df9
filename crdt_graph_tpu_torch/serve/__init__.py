"""Serving engine: snapshot-isolated reads + coalescing merge scheduler.

The layer between the HTTP handlers (service/http.py) and the replica
engine (engine.py) — see docs/SERVING.md for the design and the
consistency / backpressure contracts.  Served documents merge on the
card; ``metrics`` holds the histograms the WAL and op-log telemetry use
too.
"""
from .engine import (ECHO_LIMIT, ServedDoc, ServingEngine)
from .queue import (QueueFull, SchedulerError, SchedulerStopped,
                    WalUnavailable)
from .scheduler import MergeScheduler
from .snapshot import DocSnapshot
from .watch import WatchClosed, WatchFull, WatchRegistry, WatchStats

__all__ = ["ECHO_LIMIT", "DocSnapshot", "MergeScheduler", "QueueFull",
           "SchedulerError", "SchedulerStopped", "ServedDoc",
           "ServingEngine", "WalUnavailable", "WatchClosed",
           "WatchFull", "WatchRegistry", "WatchStats"]
