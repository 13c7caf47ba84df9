"""Honest timing on the card, and the checksum it reads back.

PyTorch returns from a CUDA call before the card has run it, so a host
clock around a call measures the enqueue.  A timed repeat here dispatches
the work, calls ``torch.cuda.synchronize()``, and reads back a scalar
fingerprint that depends on every element of the result: the clock stops
only once the answer is on the host.

:func:`fingerprint` is the reference package's checksum
(``crdt_graph_tpu.bench.honest.fingerprint``) bit for bit: a wrapping
int32 weighted sum, int64 leaves folded as two int32 halves.  Here every
partial sum is taken in int64, where it cannot overflow at any size this
package handles, and wrapped to int32 once at the end — so the order in
which the card adds the terms cannot change the answer.

- :func:`force` — the device→host copy that closes a timed region.
- :func:`audit_async_gap` — dispatch, sleep past the expected run time,
  then time the readback alone: a readback that is still long after the
  sleep means the work had not run during it, and the dispatch →
  readback times would not bracket it.  Here it checks that a CUDA
  stream's work is waited for by the readback a timed repeat ends on.
- :func:`overhead_floor_ms` — the round trip of a trivial launch and an
  8-byte copy, the fixed cost inside every timed repeat.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable

import torch


def _leaves(tree: Any) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif hasattr(tree, "__dataclass_fields__"):
        for k in tree.__dataclass_fields__:
            yield from _leaves(getattr(tree, k))
    else:
        raise TypeError(f"fingerprint: unsupported leaf {type(tree)!r}")


def wrap_i32(s: int) -> int:
    """An integer folded into signed 32-bit two's complement."""
    return ((int(s) + 2**31) % 2**32) - 2**31


def fingerprint(tree: Any) -> torch.Tensor:
    """Checksum over every tensor leaf of ``tree`` (tensors, tuples,
    lists, dicts by sorted key, dataclasses by field order), as a 0-d
    int64 tensor on the leaves' device holding a value in int32 range.
    ``wrap_i32(int(fingerprint(x)))`` equals the reference checksum of
    the same arrays."""
    s = None
    k = 0
    for a in _leaves(tree):
        if a.dtype == torch.int64:
            halves = (a >> 32, a & 0xFFFFFFFF)
        else:
            halves = (a.to(torch.int64),)
        for h in halves:
            k += 1
            part = torch.sum(h * (2 * k + 1), dtype=torch.int64)
            s = part if s is None else s + part
    if s is None:
        return torch.zeros((), dtype=torch.int64)
    # fold into int32 range on the device (one readback either way)
    return ((s + 2**31) & 0xFFFFFFFF) - 2**31


def synchronize() -> None:
    """Wait for every stream of the card, where this process has used
    one (a no-op on a CPU-only run)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def force(tree: Any) -> Any:
    """``tree`` with every tensor leaf copied to the host as a numpy
    array (the copy waits for the stream that produces it).  Give a
    timed function one stacked tensor to return, so this is one copy."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, (tuple, list)):
        return type(tree)(force(x) for x in tree)
    if isinstance(tree, dict):
        return {k: force(v) for k, v in tree.items()}
    return tree


def time_with_readback(fn: Callable[..., Any], *args, repeats: int = 5,
                       log: Callable[[str], None] = lambda m: None,
                       ) -> Dict[str, Any]:
    """Honest wall times of ``fn(*args)`` on the card: each repeat
    dispatches, synchronizes, and reads back ``fingerprint`` of the
    result.  One untimed warm-up run first.  Returns the per-repeat
    times, their p50 and min in ms, and the last fingerprint."""
    def once():
        out = fn(*args)
        synchronize()
        return int(fingerprint(out))

    t0 = time.perf_counter()
    fp = once()
    warm = time.perf_counter() - t0
    log(f"warm run in {warm * 1e3:.1f} ms")
    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        fp = once()
        times.append(time.perf_counter() - t0)
        log(f"repeat {i + 1}/{repeats}: {times[-1] * 1e3:.3f} ms")
    srt = sorted(times)
    return {
        "times_ms": [t * 1e3 for t in times],
        "p50_ms": srt[len(srt) // 2] * 1e3,
        "min_ms": srt[0] * 1e3,
        "warm_ms": warm * 1e3,
        "fingerprint": fp,
    }


def audit_async_gap(fn: Callable[..., Any], *args, expected_s: float,
                    log: Callable[[str], None] = lambda m: None,
                    ) -> Dict[str, Any]:
    """Dispatch ``fn(*args)``, sleep past the expected run time, then
    time the readback (:func:`force`) alone.  ``ok`` is False when the
    readback after the sleep took more than half the expected time (or
    250 ms): the work then only ran at the readback, and a timed repeat
    would not have bracketed it."""
    t0 = time.perf_counter()
    out = fn(*args)
    dispatch_s = time.perf_counter() - t0
    sleep_s = max(2 * expected_s, 0.5)
    time.sleep(sleep_s)
    t0 = time.perf_counter()
    force(out)
    readback_s = time.perf_counter() - t0
    ok = readback_s < max(0.5 * expected_s, 0.25)
    log(f"audit: dispatch {dispatch_s * 1e3:.1f} ms, slept {sleep_s:.1f} "
        f"s, readback {readback_s * 1e3:.3f} ms -> "
        f"{'ok' if ok else 'SUSPECT'}")
    return {
        "dispatch_ms": dispatch_s * 1e3,
        "slept_s": sleep_s,
        "readback_after_sleep_ms": readback_s * 1e3,
        "ok": bool(ok),
    }


def overhead_floor_ms(device, repeats: int = 3) -> float:
    """Median round trip of a trivial launch on ``device`` (a sum of 8
    int32) plus the 8-byte copy of its result: the fixed cost of one
    honest repeat, to read throughput against."""
    tiny = torch.arange(8, dtype=torch.int32, device=device)
    force(torch.sum(tiny + 1))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        force(torch.sum(tiny + 1))
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2] * 1e3
