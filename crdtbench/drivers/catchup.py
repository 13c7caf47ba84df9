"""Replica catch-up: one client drives a replica's engine
(``TpuTree.apply_packed``) in a closed loop.

Set-up builds the configuration's base document on one replica (one bulk
merge of the base ops on the card) and the traffic's deltas: every
replica's chain continued by ``delta_ops[k] / replicas`` ops, as packed
columns.  Each step applies one delta and then undoes it with the
engine's own ``rollback_commit``, so every step merges the same base;
the deltas come in seeded permutations of all of them.  Before a step
the state it merges against drops its timestamp index, as the
candidate set a real commit leaves behind has none, so every step
builds it again as a replica's next catch-up does.  A step is timed
from the call until ``apply_packed`` returns (it reads its statuses back
to the host).  The check compares the merged tables of a seeded sample
of steps, the largest delta among them, with the reference.
"""
from __future__ import annotations

import time

import numpy as np

from ..gen import chains, rng_for
from ..reference import check as check_mod
from . import packed_of

MAX_STEPS = 1 << 16
SAMPLE_FROM = 8         # the checked steps: drawn from the first cycle


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 trace: bool):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.trace = seed, device, trace
        self.kept = {}
        self.by_delta = {}          # delta index -> its steps' ms
        self.traced_by_delta = {}   # the same, of the traced steps

    # -- set-up -----------------------------------------------------------

    def inputs(self) -> None:
        """The cell's op columns from the seed, and which steps the check
        compares."""
        cfg, tr = self.config, self.traffic
        reps = cfg["replicas"]
        per = cfg["ops"] // reps
        self.base_cols, self.base_vals = chains.chain_rows(
            rng_for(self.seed, 1), reps, 0, per)
        self.delta_cols = []
        self.delta_vals = []
        for k, size in enumerate(tr["delta_ops"]):
            cols, vals = chains.chain_rows(rng_for(self.seed, 2, k), reps,
                                           per, size // reps)
            self.delta_cols.append(cols)
            self.delta_vals.append(vals)
        self.order = chains.delta_order(rng_for(self.seed, 3),
                                        len(tr["delta_ops"]), MAX_STEPS)
        r = rng_for(self.seed, 4)
        largest = int(np.argmax(tr["delta_ops"]))
        first_largest = int(np.nonzero(self.order == largest)[0][0])
        rest = [i for i in range(SAMPLE_FROM) if i != first_largest]
        picks = r.choice(rest, tr["checked_steps"] - 1, replace=False)
        self.sample = {first_largest, *map(int, picks)}

    def candidates(self, k: int) -> dict:
        """The columns a step of delta ``k`` merges: the base, then the
        delta."""
        return {f: np.concatenate([self.base_cols[f], self.delta_cols[k][f]])
                for f in ("kind", "ts", "depth", "paths")}

    def checked(self) -> list:
        """(key, candidate columns) of every answer the check compares."""
        return [(i, self.candidates(int(self.order[i])))
                for i in sorted(self.sample)]

    def setup(self) -> None:
        t_imp = time.perf_counter()
        from crdt_graph_tpu_torch import engine
        t0 = time.perf_counter()
        self.inputs()
        self.delta_p = [packed_of(c, v) for c, v in zip(self.delta_cols,
                                                       self.delta_vals)]
        t1 = time.perf_counter()
        self.tree = engine.TpuTree(self.config["local_replica"],
                                   device=self.device)
        self.tree.apply_packed(packed_of(self.base_cols, self.base_vals))
        for p in self.delta_p:
            if not self.tree.packed_route(p.num_ops):
                raise RuntimeError(f"a delta of {p.num_ops} ops is below "
                                   f"the bulk route's crossover")
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
        self.tree.apply_packed(p)
        t1 = time.perf_counter()
        table = self.tree._table      # the merged table the step parked
        self.tree.rollback_commit(saved)
        return t1 - t0, table

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
            k = int(self.order[i % MAX_STEPS])
            p = self.delta_p[k]
            try:
                dt, table = self.step(p)
            except Exception as e:  # noqa: BLE001 - a failed step counts
                failed += 1
                self.error = repr(e)
            else:
                lat.append(dt * 1e3)
                ops.append(self.base_ops + p.num_ops)
                self.by_delta.setdefault(k, []).append(dt * 1e3)
                if tracer is not None and tracer.on:
                    traced_ops.append(ops[-1])
                    self.traced_by_delta.setdefault(k, []).append(dt)
                if i in self.sample:
                    self.kept[i] = (k, table)
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
        self.summary = "step ms by delta (median, n): " + ", ".join(
            f"{self.traffic['delta_ops'][k]}: {np.median(v):.1f} {len(v)}"
            for k, v in sorted(self.by_delta.items())) + (
            "; all steps ms quartiles %s" % np.round(
                np.percentile(lat, [25, 50, 75]), 1) if lat else "")
        return {"window_s": t_end - t_start, "latencies_ms": lat,
                "ops": ops, "traced_ops": traced_ops,
                "attempted": i, "failed": failed,
                "fallbacks": merge_mod.fallbacks - fallbacks0}

    # -- after the window (untimed) ----------------------------------------

    def host_tables(self) -> None:
        """The kept tables to the host, then the program's state freed."""
        out = {}
        for i, (k, t) in self.kept.items():
            n = self.base_ops + self.delta_p[k].num_ops
            out[i] = check_mod.table_view(
                t.ts.cpu().numpy(), t.visible_order.cpu().numpy(),
                t.num_visible.cpu().numpy(), t.depth.cpu().numpy(),
                t.parent.cpu().numpy(), t.status.cpu().numpy(),
                n) if t is not None else check_mod.empty_view()
        self.kept = out
        self.tree = None

    def spans(self) -> list:
        """(object, attribute, label) of the program calls a traced
        window annotates."""
        from crdt_graph_tpu_torch import convert
        from crdt_graph_tpu_torch.codec.packed import PackedOps
        from crdt_graph_tpu_torch.ops import merge
        t = self.tree
        return [(t, "prepare_packed", "engine.prepare_packed"),
                (t._log, "to_packed", "oplog.to_packed"),
                (PackedOps, "arrays", "packed.arrays"),
                (convert, "ops_from_numpy", "convert.ops_from_numpy"),
                (merge, "_materialize", "merge.stages"),
                (t, "finish_packed", "engine.finish_packed"),
                (t, "rollback_commit", "engine.rollback_commit")]

    def audit(self) -> dict:
        """The trace audit of one step of the largest delta."""
        from crdt_graph_tpu_torch.utils import chainaudit
        p = self.delta_p[int(np.argmax(self.traffic["delta_ops"]))]
        with chainaudit.Audit() as a:
            self.step(p)
        res = a.result()
        return {**res.summary(), "read_syncs": res.read_syncs}

    def kernel_bound_ms(self) -> float:
        """The hand kernels' bound over the traced steps: one step of
        each delta captured, times the traced steps it had."""
        from ..kernelwork import Capture
        total = 0.0
        for k, steps in self.traced_by_delta.items():
            with Capture() as c:
                self.step(self.delta_p[k])
            total += len(steps) * c.bound_ms
        return total

    def check(self) -> tuple:
        """(mismatch counts, answers compared, answers missing)."""
        counts = [check_mod.judge(self.kept[i], cols, len(cols["ts"]))
                  for i, cols in self.checked() if i in self.kept]
        missing = len(self.sample) - len(self.kept)
        return check_mod.add_up(counts), len(self.kept), missing
