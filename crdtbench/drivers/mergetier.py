"""A front-end's remote merges through the merge tier: one client, in a
closed loop, catches a replica up on a peer's backlog by the merge
worker, as the serving scheduler's remote stage does for one document
(``serve/scheduler.Scheduler._process_remote``).

A step is that stage's sequence: ``TpuTree.prepare_packed(delta)`` (the
candidate set, base ∪ delta), ``MergeTierClient.merge_one`` against an
in-process ``MergeWorker`` at its defaults (the wire codec both ways,
the linger batcher, one batched merge of the epoch on the card, the
read-back, the client's verification), ``codec.packed.with_capacity``
to the worker's shared capacity, and ``TpuTree.finish_packed`` (the
commit), timed from the first call until the commit returns; then the
engine's ``rollback_commit``, so every step merges the same base.  A
step whose merge falls back (``MergeFallback``) counts as failed: it
would measure the front-end's local merge, not the tier.

Set-up builds the configuration's base document on the replica (one
bulk merge on the card) and the traffic's deltas, each continuing every
replica's counters under the same branches; the rest (sampling, the
window, the check) is the catch-up driver's.
"""
from __future__ import annotations

import time

import numpy as np

from ..gen import chains, nested, rng_for
from ..reference import check as check_mod
from . import catchup, packed_of

DOC_ID = "outline"


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


class Driver(catchup.Driver):
    # -- set-up -----------------------------------------------------------

    def inputs(self) -> None:
        """The cell's op columns from the seed, and which steps the check
        compares."""
        cfg, tr = self.config, self.traffic
        reps, depth = cfg["replicas"], cfg["depth"]
        self.base_cols, self.base_vals = nested.nested_rows(
            rng_for(self.seed, 1), reps, depth, np.zeros(reps, np.int64),
            cfg["ops"])
        after = nested.counters_after(self.base_cols, reps)
        self.delta_cols, self.delta_vals = [], []
        for k, size in enumerate(tr["delta_ops"]):
            cols, vals = nested.nested_rows(rng_for(self.seed, 2, k), reps,
                                            depth, after, size)
            self.delta_cols.append(cols)
            self.delta_vals.append(vals)
        self.order = chains.delta_order(rng_for(self.seed, 3),
                                        len(tr["delta_ops"]),
                                        catchup.MAX_STEPS)
        r = rng_for(self.seed, 4)
        largest = int(np.argmax(tr["delta_ops"]))
        first_largest = int(np.nonzero(self.order == largest)[0][0])
        rest = [i for i in range(catchup.SAMPLE_FROM) if i != first_largest]
        picks = r.choice(rest, tr["checked_steps"] - 1, replace=False)
        self.sample = {first_largest, *map(int, picks)}

    def setup(self) -> None:
        t_imp = time.perf_counter()
        from crdt_graph_tpu_torch import engine, mergetier
        from crdt_graph_tpu_torch.codec import packed as packed_mod
        self.with_capacity = packed_mod.with_capacity
        t0 = time.perf_counter()
        self.inputs()
        self.delta_p = [packed_of(c, v) for c, v in zip(self.delta_cols,
                                                       self.delta_vals)]
        t1 = time.perf_counter()
        self.tree = engine.TpuTree(self.config["local_replica"],
                                   device=self.device)
        self.tree.apply_packed(packed_of(self.base_cols, self.base_vals))
        self.worker = mergetier.MergeWorker(device=self.device)
        self.client = mergetier.MergeTierClient([self.worker])
        for p in self.delta_p:
            if not (self.tree.packed_route(p.num_ops)
                    and p.num_ops >= mergetier.route_min_ops()):
                raise RuntimeError(f"a delta of {p.num_ops} ops would not "
                                   f"ship to the merge tier")
        t2 = time.perf_counter()
        # every candidate set pads to one capacity: one step warms them
        self.step(max(self.delta_p, key=lambda p: p.num_ops))
        self.base_ops = self.tree.log_length
        self.setup_phases = {"program import": t0 - t_imp,
                             "inputs": t1 - t0, "base merge": t2 - t1,
                             "warm step": time.perf_counter() - t2}

    def step(self, p):
        self.tree.packed_state().ts_index = None
        saved = self.tree.begin_commit()
        t0 = time.perf_counter()
        prep = self.tree.prepare_packed(p)
        table, shared, _, _ = self.client.merge_one(DOC_ID, prep, p.num_ops)
        self.tree.finish_packed(p, self.with_capacity(prep, shared), table)
        t1 = time.perf_counter()
        table = self.tree._table      # the table the front-end committed
        self.tree.rollback_commit(saved)
        return t1 - t0, table

    # -- after the window (untimed) ----------------------------------------

    def host_tables(self) -> None:
        """The kept tables as host arrays, then the program's state
        freed."""
        out = {}
        for i, (k, t) in self.kept.items():
            n = self.base_ops + self.delta_p[k].num_ops
            out[i] = check_mod.table_view(
                *(_host(getattr(t, f)) for f in (
                    "ts", "visible_order", "num_visible", "depth", "parent",
                    "status")), n) if t is not None \
                else check_mod.empty_view()
        self.kept = out
        self.worker.close()
        self.tree = self.worker = self.client = None

    def spans(self) -> list:
        """(object, attribute, label) of the program calls a traced
        window annotates."""
        from crdt_graph_tpu_torch import convert
        from crdt_graph_tpu_torch.codec.packed import PackedOps
        from crdt_graph_tpu_torch.mergetier import wire
        from crdt_graph_tpu_torch.mergetier import worker as worker_mod
        from crdt_graph_tpu_torch.ops import merge
        from crdt_graph_tpu_torch.parallel import mesh
        t = self.tree
        return [(t, "prepare_packed", "engine.prepare_packed"),
                (t._log, "to_packed", "oplog.to_packed"),
                (self.client, "merge_one", "mergetier.merge_one"),
                (wire, "encode_request", "mergetier.encode_request"),
                (wire, "decode_request", "mergetier.decode_request"),
                (self.worker.batcher, "submit", "batcher.submit"),
                (mesh, "stack_aligned", "mesh.stack_aligned"),
                (PackedOps, "arrays", "packed.arrays"),
                (convert, "ops_from_numpy", "convert.ops_from_numpy"),
                (merge, "_materialize", "merge.stages"),
                (worker_mod, "read_back", "mergetier.read_back"),
                (wire, "encode_response", "mergetier.encode_response"),
                (wire, "decode_response", "mergetier.decode_response"),
                (t, "finish_packed", "engine.finish_packed"),
                (t, "rollback_commit", "engine.rollback_commit")]
