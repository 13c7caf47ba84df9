"""The merge worker: the tier's compute half.

One worker owns the card and does exactly one thing: accumulate
``/merge`` requests — each a document's prepared candidate set, from
ANY front-end in the fleet — inside a
:class:`~crdt_graph_tpu_torch.parallel.mesh.LingerBatcher` window
(``GRAFT_MERGETIER_BATCH_MS`` linger, ``GRAFT_MERGETIER_MAX_WIDTH``
cap), then merge the whole epoch as ONE batched merge on its device
(``stack_aligned`` + ``batched_materialize``: one chain of dispatches
over a leading document axis, every document at the shared capacity),
read the epoch back to the host once, and hand each requester its own
document's slice of the table.  The worker is stateless per
request (the candidate set arrives complete), so workers are a POOL:
any request may go to any live worker, death loses no state, and the
front-end's fallback ladder (mergetier/client.py) makes every failure
mode a local merge instead of a failed write.

Served two ways, same handler:

- over HTTP — ``service.http`` routes ``POST /merge`` to any store
  exposing :meth:`MergeWorker.handle_merge`; :class:`MergeWorkerServer`
  is the process twin of ``cluster.gateway.FleetServer``;
- in process — the transport twin: tests (and single-process
  deployments) hand the :class:`MergeWorker` itself to the client,
  which calls :meth:`handle_merge` directly.  Same bytes, same codec,
  same batcher.

The batcher serializes epochs, so one thread at a time (the epoch
leader's) launches, however many HTTP handler threads park in
:meth:`handle_merge`.  It launches on that thread's current stream,
the default stream: a front-end's local merges in the same process
(the scheduler thread) share it.
"""
from __future__ import annotations

import json
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

import torch

from ..ops import merge as merge_mod
from ..ops.merge import FIELDS, NodeTable
from ..serve.metrics import Histogram
from ..utils import profiling
from ..utils.hostenv import env_float as _env_float
from ..utils.hostenv import env_int as _env_int
from . import wire

DEFAULT_BATCH_MS = 2.0
DEFAULT_MAX_WIDTH = 16
# achieved cross-doc launch width (the headline distribution)
WIDTH_BOUNDS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)


class MergeWorker:
    """Pooled merge compute behind ``POST /merge`` (docs/MERGETIER.md)."""

    def __init__(self, linger_ms: Optional[float] = None,
                 max_width: Optional[int] = None,
                 name: str = "mergeworker", device=None):
        from ..parallel import mesh as mesh_mod
        self.name = name
        # every epoch merges on this device: the card unless the caller
        # names another; no card and no device= raises
        self.device = merge_mod.resolve_device(device)
        if linger_ms is None:
            linger_ms = _env_float("GRAFT_MERGETIER_BATCH_MS",
                                   DEFAULT_BATCH_MS)
        if max_width is None:
            max_width = _env_int("GRAFT_MERGETIER_MAX_WIDTH",
                                 DEFAULT_MAX_WIDTH)
        self.batcher = mesh_mod.LingerBatcher(
            self._launch, linger_s=max(0.0, linger_ms) / 1e3,
            max_width=max_width)
        self.width_hist = Histogram(WIDTH_BOUNDS)
        self._lock = threading.Lock()
        self._dead = False
        # wall time of the most recent epoch launch (ms) — echoed to
        # traced requests so the front-end can split its remote_merge
        # stage into transport vs queue vs launch without a worker-side
        # clock crossing
        self._last_launch_ms = 0.0
        self.requests = 0
        self.merged_docs = 0
        self.merged_ops = 0
        self.wire_errors = 0
        self.launch_errors = 0

    # -- the epoch launch (leader thread) ---------------------------------

    @profiling.span("mergetier.launch")
    def _launch(self, cargo: List[Tuple[object, Dict]]):
        """One epoch: align every request's candidate set to the shared
        capacity, stack, merge the documents as one batched merge on
        the worker's device, and read the epoch back to the host in ONE
        copy (the wire format either way; no table stays on the card).
        Runs on the epoch leader's thread."""
        from ..parallel import mesh as mesh_mod
        t0 = time.perf_counter()
        prepared = [p for p, _ in cargo]
        stacked, aligned = mesh_mod.stack_aligned(prepared)
        btab = mesh_mod.batched_materialize(stacked, device=self.device)
        with profiling.span("mergetier.read_back"):
            host = read_back(btab)
        with self._lock:
            self._last_launch_ms = (time.perf_counter() - t0) * 1e3
        width = len(cargo)
        profiling.count("mergetier.epoch_width", width)
        shared = aligned[0].capacity
        self.width_hist.observe(width)
        return [(table, shared, width) for table in host]

    # -- the request surface (handler threads) ----------------------------

    def handle_merge(self, body: bytes) -> Tuple[int, bytes, Dict]:
        """The ``POST /merge`` handler: decode → ride the linger window
        → encode this document's slice.  Returns ``(status, body,
        headers)`` exactly like the fleet forward path, so the HTTP
        layer and the in-process transport serve identical bytes."""
        if self._dead:
            # simulated worker death (tests; a real dead worker just
            # stops answering) — the client's transport error path
            return 503, json.dumps(
                {"error": "merge worker shutting down"}).encode(), \
                {"Content-Type": "application/json"}
        try:
            with profiling.span("mergetier.decode_request"):
                p, meta = wire.decode_request(body)
        except wire.MergeWireError as e:
            with self._lock:
                self.wire_errors += 1
            return 400, json.dumps({"error": str(e)}).encode(), \
                {"Content-Type": "application/json"}
        with self._lock:
            self.requests += 1
        t_sub = time.perf_counter()
        try:
            table, shared, width = self.batcher.submit((p, meta))
        except Exception as e:   # noqa: BLE001 — a failed epoch must
            # answer every rider (the front-ends fall back locally);
            # CrashPoint is a BaseException and still propagates.  A
            # CUDA error lands here too: logged, counted, answered.
            with self._lock:
                self.launch_errors += 1
            print(f"merge worker {self.name}: epoch failed",
                  file=sys.stderr)
            traceback.print_exception(e, file=sys.stderr)
            return 500, json.dumps(
                {"error": f"batched launch failed: {e!r}"}).encode(), \
                {"Content-Type": "application/json"}
        with self._lock:
            self.merged_docs += 1
            self.merged_ops += p.num_ops
            last_launch_ms = self._last_launch_ms
        extra = None
        if meta.get("trace") is not None:
            # split this request's in-worker wait into linger-queue vs
            # launch using monotonic durations only (never a clock
            # crossing): the epoch's launch time caps at the wait —
            # whatever precedes it inside the wait was the queue
            wait_ms = (time.perf_counter() - t_sub) * 1e3
            launch_ms = min(last_launch_ms, wait_ms)
            extra = {"worker": self.name,
                     "worker_ms": {
                         "wait": round(wait_ms, 3),
                         "queue": round(max(0.0, wait_ms - launch_ms),
                                        3),
                         "launch": round(launch_ms, 3)}}
        with profiling.span("mergetier.encode_response"):
            resp = wire.encode_response(table, shared, width,
                                        meta["input_digest"], extra=extra)
        return 200, resp, {"Content-Type": "application/octet-stream"}

    # -- lifecycle / telemetry --------------------------------------------

    def crash(self) -> None:
        """Simulate worker death: every later request answers 503 (the
        in-process twin of killing the worker process mid-run)."""
        self._dead = True
        self.batcher.close()

    def close(self) -> None:
        self._dead = True
        self.batcher.close()

    def render_prom(self) -> str:
        """``GET /metrics/prom`` on a worker server (service/http.py
        dispatches on this attribute) — the worker-side
        ``crdt_mergetier_worker_*`` families, linger occupancy
        included."""
        from ..obs import prom as prom_mod
        return prom_mod.render_merge_worker(self)

    def stats(self) -> Dict:
        with self._lock:
            out = {"name": self.name,
                   "requests": self.requests,
                   "merged_docs": self.merged_docs,
                   "merged_ops": self.merged_ops,
                   "wire_errors": self.wire_errors,
                   "launch_errors": self.launch_errors,
                   "dead": self._dead}
        out["batch_width"] = self.width_hist.export()
        out["batcher"] = self.batcher.stats()
        return out


class MergeWorkerServer:
    """One merge worker behind a real HTTP server (the process shape;
    ``FleetServer``'s thin twin).  ``service.http.make_handler`` routes
    ``POST /merge`` here because the worker exposes ``handle_merge``;
    every other route 404s — a worker is not a replica."""

    def __init__(self, worker: Optional[MergeWorker] = None,
                 port: int = 0, device=None):
        import threading as _threading

        from ..service import make_server
        self.worker = worker if worker is not None \
            else MergeWorker(device=device)
        self.server = make_server(port=port, store=self.worker)
        self.port = self.server.server_port
        self.addr = f"127.0.0.1:{self.port}"
        self._thread = _threading.Thread(
            target=self.server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.worker.close()
        self._thread.join(10)

    def crash(self) -> None:
        """Kill the serving loop without draining — the netchaos/death
        legs' worker-side severance: ``server_close`` also severs every
        established keep-alive connection, so a front-end's next request
        meets a transport error, as against a killed process."""
        self.worker.crash()
        self.server.shutdown()
        self.server.server_close()
        self._thread.join(10)


def read_back(btab: NodeTable) -> List[NodeTable]:
    """The epoch's batched table → one host-numpy :class:`NodeTable` a
    document, by ONE device-to-host copy: every field is viewed as bytes
    and concatenated on the device (each padded to 8 bytes, so every
    view below is aligned), copied once, then cut back into (dtype,
    shape) views on the host and sliced by document."""
    parts, layout = [], []
    for f in FIELDS:
        a = getattr(btab, f)
        nbytes = a.numel() * a.element_size()
        layout.append((f, a.dtype, tuple(a.shape), nbytes))
        parts.append(a.contiguous().reshape(-1).view(torch.uint8))
        if nbytes % 8:
            parts.append(a.new_zeros(8 - nbytes % 8, dtype=torch.uint8))
    flat = torch.cat(parts).cpu().numpy()
    cols, off = {}, 0
    for f, dtype, shape, nbytes in layout:
        np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
        cols[f] = flat[off:off + nbytes].view(np_dtype).reshape(shape)
        off += -(-nbytes // 8) * 8
    return [NodeTable(**{f: cols[f][i, ...] for f in FIELDS})
            for i in range(int(btab.status.shape[0]))]
