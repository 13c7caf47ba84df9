"""A cross-document scheduling round: one client drives the replica
engine's grouped merge (``engine.apply_packed_grouped``) over all of the
configuration's documents in a closed loop, as the serving scheduler
does when several busy documents each get a backlog chunk in the same
round (``serve/scheduler.Scheduler._process_grouped``).

Set-up builds each document on a replica of its own (one bulk merge of
its base ops on the card).  Document d's replica r has id
``replicas * d + r``, so no two documents share a timestamp and a table
read from the wrong document cannot match the reference.  Each
document gets every delta size of the traffic, each continuing all of
its replicas' chains.  Set-up also checks that every delta lies in the
scheduler's grouping window: it takes the bulk route
(``TpuTree.packed_route``), fits one chunk
(``serve.engine.DEFAULT_CHUNK_OPS``), and every candidate set
(log ∪ delta) falls in one bucket.

A step gives document d the delta of size ``delta_ops[perm[d]]``, with
``perm`` a seeded permutation drawn anew each step, so every step
merges each size once.  Before the step each document's state drops its
timestamp index, as the catch-up driver's does.  The step is the one
``apply_packed_grouped`` call, timed until it returns (each document's
statuses are then on the host); then each document undoes its commit
with the engine's own ``rollback_commit``, so every step merges the same
bases.  A step in which any document is rejected counts as failed.
The check compares every document's merged table of a seeded sample of
steps, each with the reference of that document's own candidate set.
"""
from __future__ import annotations

import time

import numpy as np

from ..gen import OFFSET, chains, rng_for
from ..reference import check as check_mod
from . import packed_of

MAX_STEPS = 1 << 12
SAMPLE_FROM = 8         # the checked steps: drawn from the first eight


def shifted(cols: dict, first_replica: int) -> dict:
    """``cols`` of replicas ``1..R`` moved to replicas
    ``first_replica + 1..first_replica + R``: every timestamp, and every
    reference to one, shifted (the root's and the head's 0 stay)."""
    shift = np.int64(first_replica) * OFFSET
    out = dict(cols)
    for k in ("ts", "parent_ts", "anchor_ts", "paths"):
        out[k] = np.where(cols[k] > 0, cols[k] + shift, cols[k])
    return out


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 trace: bool):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.trace = seed, device, trace
        self.kept = {}
        self.traced_steps = 0

    # -- set-up -----------------------------------------------------------

    def inputs(self) -> None:
        """Every document's op columns from the seed, the steps'
        permutations, and which steps the check compares."""
        cfg, tr = self.config, self.traffic
        docs, reps = cfg["documents"], cfg["replicas"]
        if len(tr["delta_ops"]) != docs:
            raise ValueError("a round gives each document one of the "
                             "delta sizes: as many sizes as documents")
        per = cfg["ops"] // reps
        self.base_cols, self.base_vals = [], []
        self.delta_cols, self.delta_vals = [], []
        for d in range(docs):
            cols, vals = chains.chain_rows(rng_for(self.seed, 1, d), reps,
                                           0, per)
            self.base_cols.append(shifted(cols, reps * d))
            self.base_vals.append(vals)
            dc, dv = [], []
            for k, size in enumerate(tr["delta_ops"]):
                cols, vals = chains.chain_rows(rng_for(self.seed, 2, d, k),
                                               reps, per, size // reps)
                dc.append(shifted(cols, reps * d))
                dv.append(vals)
            self.delta_cols.append(dc)
            self.delta_vals.append(dv)
        self.order = rng_for(self.seed, 3).permuted(
            np.tile(np.arange(docs), (MAX_STEPS, 1)), axis=1)
        picks = rng_for(self.seed, 4).choice(SAMPLE_FROM,
                                             tr["checked_steps"],
                                             replace=False)
        self.sample = set(map(int, picks))

    def candidates(self, d: int, k: int) -> dict:
        """The columns document ``d`` merges in a step that gives it
        delta ``k``: its base, then the delta."""
        return {f: np.concatenate([self.base_cols[d][f],
                                   self.delta_cols[d][k][f]])
                for f in ("kind", "ts", "depth", "paths")}

    def checked(self) -> list:
        """((step, document), candidate columns) of every answer the
        check compares."""
        return [((i, d), self.candidates(d, int(self.order[i][d])))
                for i in sorted(self.sample)
                for d in range(self.config["documents"])]

    def setup(self) -> None:
        t_imp = time.perf_counter()
        from crdt_graph_tpu_torch import engine
        from crdt_graph_tpu_torch.codec import packed as packed_mod
        from crdt_graph_tpu_torch.serve.engine import DEFAULT_CHUNK_OPS
        if not hasattr(engine, "apply_packed_grouped"):
            raise RuntimeError("the program has no grouped merge "
                               "(engine.apply_packed_grouped)")
        self.engine = engine
        t0 = time.perf_counter()
        self.inputs()
        self.delta_p = [[packed_of(c, v) for c, v in zip(cs, vs)]
                        for cs, vs in zip(self.delta_cols, self.delta_vals)]
        t1 = time.perf_counter()
        self.trees = []
        for cols, vals in zip(self.base_cols, self.base_vals):
            tree = engine.TpuTree(self.config["local_replica"],
                                  device=self.device)
            tree.apply_packed(packed_of(cols, vals))
            self.trees.append(tree)
        self.base_ops = [t.log_length for t in self.trees]
        buckets = set()
        for tree, ps in zip(self.trees, self.delta_p):
            for p in ps:
                if not (tree.packed_route(p.num_ops)
                        and p.num_ops <= DEFAULT_CHUNK_OPS):
                    raise RuntimeError(
                        f"a delta of {p.num_ops} ops on a "
                        f"{tree.log_length}-op log lies outside the "
                        f"scheduler's grouping window")
                buckets.add(packed_mod._bucket(tree.log_length + p.num_ops))
        if len(buckets) != 1:
            raise RuntimeError(f"the candidate sets fall in buckets "
                               f"{sorted(buckets)}, not one")
        t2 = time.perf_counter()
        # every step stacks to one shape: one step warms it
        self.step(self.order[0])
        self.setup_phases = {"program import": t0 - t_imp,
                             "inputs": t1 - t0, "base merges": t2 - t1,
                             "warm step": time.perf_counter() - t2}

    def step(self, perm):
        """One round: document d merges delta ``perm[d]``.  Returns the
        seconds the grouped call took and each document's parked
        table."""
        saved = []
        for tree in self.trees:
            tree.packed_state().ts_index = None
            saved.append(tree.begin_commit())
        ps = [self.delta_p[d][int(k)] for d, k in enumerate(perm)]
        t0 = time.perf_counter()
        errors = self.engine.apply_packed_grouped(self.trees, ps)
        t1 = time.perf_counter()
        tables = [tree._table for tree in self.trees]
        for tree, s in zip(self.trees, saved):
            tree.rollback_commit(s)
        for e in errors:
            if e is not None:
                raise e
        return t1 - t0, tables

    # -- the window -------------------------------------------------------

    def window(self, seconds: float, tracer=None) -> dict:
        """Steps until ``seconds`` have passed; the window ends with the
        step that crosses it.  A ``tracer`` profiles the steps up to the
        first that ends ``tracer.seconds`` into the window."""
        from crdt_graph_tpu_torch.ops import merge as merge_mod
        lat, ops, traced_ops = [], [], []
        fallbacks0 = merge_mod.fallbacks
        i, failed = 0, 0
        if tracer is not None:
            tracer.start()
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while True:
            perm = self.order[i % MAX_STEPS]
            try:
                dt, tables = self.step(perm)
            except Exception as e:  # noqa: BLE001 - a failed step counts
                failed += 1
                self.error = repr(e)
            else:
                lat.append(dt * 1e3)
                ops.append(sum(b + self.delta_p[d][int(k)].num_ops
                               for d, (b, k) in enumerate(
                                   zip(self.base_ops, perm))))
                if tracer is not None and tracer.on:
                    traced_ops.append(ops[-1])
                if i in self.sample:
                    for d, t in enumerate(tables):
                        self.kept[(i, d)] = (int(perm[d]), t)
            i += 1
            now = time.perf_counter()
            if tracer is not None and tracer.on \
                    and now - t_start >= tracer.seconds:
                tracer.stop()
            if now >= deadline:
                break
        t_end = time.perf_counter()
        if tracer is not None and tracer.on:
            tracer.stop()
        self.traced_steps = len(traced_ops)
        self.summary = ("grouped steps ms quartiles %s over %d steps" % (
            np.round(np.percentile(lat, [25, 50, 75]), 1), len(lat))
            if lat else "no step completed")
        return {"window_s": t_end - t_start, "latencies_ms": lat,
                "ops": ops, "traced_ops": traced_ops,
                "attempted": i, "failed": failed,
                "fallbacks": merge_mod.fallbacks - fallbacks0}

    # -- after the window (untimed) ----------------------------------------

    def host_tables(self) -> None:
        """The kept tables to the host, then the program's state freed."""
        out = {}
        for (i, d), (k, t) in self.kept.items():
            n = self.base_ops[d] + self.delta_p[d][k].num_ops
            out[(i, d)] = check_mod.table_view(
                t.ts.cpu().numpy(), t.visible_order.cpu().numpy(),
                t.num_visible.cpu().numpy(), t.depth.cpu().numpy(),
                t.parent.cpu().numpy(), t.status.cpu().numpy(),
                n) if t is not None else check_mod.empty_view()
        self.kept = out
        self.trees = None

    def spans(self) -> list:
        """(object, attribute, label) of the program calls a traced
        window annotates."""
        from crdt_graph_tpu_torch import convert
        from crdt_graph_tpu_torch.oplog import OpLog
        from crdt_graph_tpu_torch.ops import merge
        from crdt_graph_tpu_torch.parallel import mesh
        tree = self.engine.TpuTree
        return [(self.engine, "apply_packed_grouped", "engine.apply_grouped"),
                (tree, "prepare_packed", "engine.prepare_packed"),
                (OpLog, "to_packed", "oplog.to_packed"),
                (mesh, "stack_aligned", "mesh.stack_aligned"),
                (convert, "ops_from_numpy", "convert.ops_from_numpy"),
                (merge, "_materialize", "merge.stages"),
                (tree, "finish_packed", "engine.finish_packed"),
                (tree, "rollback_commit", "engine.rollback_commit")]

    def audit(self) -> dict:
        """The trace audit of one grouped step: one batched merge of
        every document."""
        from crdt_graph_tpu_torch.utils import chainaudit
        with chainaudit.Audit() as a:
            self.step(self.order[0])
        res = a.result()
        return {**res.summary(), "read_syncs": res.read_syncs}

    def kernel_bound_ms(self) -> float:
        """The hand kernels' bound over the traced steps: one grouped step
        captured (every step merges each delta size once), times the
        traced steps."""
        from ..kernelwork import Capture
        with Capture() as c:
            self.step(self.order[0])
        return self.traced_steps * c.bound_ms

    def check(self) -> tuple:
        """(mismatch counts, answers compared, answers missing)."""
        keys = self.checked()
        counts = [check_mod.judge(self.kept[key], cols, len(cols["ts"]))
                  for key, cols in keys if key in self.kept]
        missing = len(keys) - sum(key in self.kept for key, _ in keys)
        return check_mod.add_up(counts), len(counts), missing
