"""Differential soak: many randomized multi-replica sessions, each checked
merge-vs-oracle (visible sequence + statuses + permutation convergence +
all three hint modes) — the port's counterpart of ``scripts/soak.py``,
its merges on the card unless ``device`` names another.

Run: ``python -m crdt_graph_tpu_torch.scripts.soak [n_sessions]
[--device cpu]``.  Writes the sessions' op counts and a digest of every
session's converged values, with the card's tag, to
``build/headline/BENCH_SOAK.json``.
"""
import hashlib
import json
import random
import sys

from . import _headline
from .. import engine
from ..codec import packed
from ..core import operation as op_mod
from ..core import tree as tree_mod
from ..core.errors import CRDTError
from ..ops import merge, view


def random_session(seed):
    """Richer than the test-suite generator: varied replica counts,
    delete rates, nesting rates, duplicate redelivery."""
    rng = random.Random(seed)
    n_replicas = rng.choice([2, 3, 5, 8])
    steps = rng.choice([60, 150, 300])
    p_branch = rng.choice([0.05, 0.2, 0.4])
    p_delete = rng.choice([0.05, 0.2, 0.45])
    trees = [tree_mod.init(r + 1) for r in range(n_replicas)]
    for _ in range(steps):
        i = rng.randrange(n_replicas)
        t = trees[i]
        roll = rng.random()
        try:
            if roll < p_delete:
                vis = []
                t.walk(lambda n, acc: ("take", acc.append(n.path) or acc),
                       vis)
                if vis:
                    t = t.delete(rng.choice(vis))
            elif roll < p_delete + p_branch:
                t = t.add_branch(rng.randrange(1000))
            elif roll < 0.85:
                t = t.add(rng.randrange(1000))
            else:
                j = rng.randrange(n_replicas)
                if j != i:
                    t = t.apply(trees[j].operations_since(0))
        except CRDTError:
            pass
        trees[i] = t
    for i in range(n_replicas):
        for j in range(n_replicas):
            if i != j:
                trees[i] = trees[i].apply(trees[j].operations_since(0))
    ops = op_mod.to_list(trees[0].operations_since(0))
    return trees[0], ops, rng


def check(seed, dev=None):
    """Session ``seed`` checked on ``dev``: returns ``(op count, the
    oracle's visible values)``."""
    merged, ops, rng = random_session(seed)
    want = merged.visible_values()
    # deep-nesting sessions exceed the default 16-deep path bucket; the
    # kernel is depth-generic, so size the bucket from the session
    md = max(16, max((len(op.path) for op in ops
                      if hasattr(op, "path")), default=1))
    p = packed.pack(ops, max_depth=md)
    for mode in (None, "exhaustive", "join"):
        t = view.to_host(merge.materialize(p.arrays(), hints=mode,
                                           device=dev))
        got = view.visible_values(t, p.values)
        assert got == want, (seed, mode, "visible mismatch")
    # shuffled delivery incl. a duplicated slice
    perm = ops[:] + ops[: len(ops) // 3]
    rng.shuffle(perm)
    p2 = packed.pack(perm, max_depth=md)
    t2 = view.to_host(merge.materialize(p2.arrays(), device=dev))
    assert view.visible_values(t2, p2.values) == want, (seed, "perm+dup")

    # columnar engine path (round 5): the same causal log ingested
    # through TpuTree.apply_packed in random chunk splits — log stays
    # column segments, duplicates within the redelivered overlap absorb
    # via select_rows — then a binary checkpoint round trip and an
    # indexed operations_since suffix, all against the oracle.
    # Sampled ~1-in-3 via the session rng (as the reference samples
    # it), with the FIRST session always checked so short runs cannot
    # skip engine coverage entirely
    if seed != 1000 and rng.random() > 1 / 3:
        return len(ops), want
    eng = engine.init(0, max_depth=md, device=dev)
    i = 0
    while i < len(ops):
        k = rng.choice([7, 60, 400, len(ops)])
        chunk = ops[max(0, i - rng.choice([0, 3])):i + k]   # overlap dups
        eng.apply_packed(packed.pack(chunk, max_depth=md))
        i += k
    assert eng.visible_values() == want, (seed, "engine columnar")
    assert eng.log_length == len(ops), (seed, "engine log len")
    import io
    buf = io.BytesIO()
    eng.checkpoint_packed(buf, compress=False)
    buf.seek(0)
    rest = engine.TpuTree.restore_packed(buf, device=dev)
    assert rest.visible_values() == want, (seed, "checkpoint roundtrip")
    if ops:
        mid = ops[rng.randrange(len(ops))]
        ts_mid = op_timestamp_of(mid)
        if ts_mid is not None:
            suffix = eng.operations_since(ts_mid)
            oracle_suffix = merged.operations_since(ts_mid)
            assert op_mod.to_list(suffix) == \
                op_mod.to_list(oracle_suffix), (seed, "since suffix")
    return len(ops), want


def op_timestamp_of(op):
    return op_mod.op_timestamp(op)


def values_digest(values) -> str:
    """A digest of one session's converged values, comparable across
    packages (the reference's soak converges the same seeds)."""
    return hashlib.sha1(json.dumps(values).encode()).hexdigest()[:16]


def run(n: int = 60, out_path: str = None, device=None) -> dict:
    dev = _headline.resolve(device)
    total, digests, visible = 0, [], []
    for k in range(n):
        n_ops, want = check(1000 + k, dev)
        total += n_ops
        digests.append(values_digest(want))
        visible.append(len(want))
        if (k + 1) % 10 == 0:
            print(f"soak: {k + 1}/{n} sessions ok ({total} ops total)",
                  flush=True)
    print(f"SOAK OK: {n} sessions, {total} ops")
    block = _headline.device_block(dev)
    out = {"bench": "soak", "sessions": n, "ops": total,
           "host": _headline.platform_tag(block), "device": block,
           "visible": visible, "values_digests": digests}
    _headline.write(out, out_path or _headline.out_path("soak"))
    return out


def main(argv=None) -> int:
    device, argv = _headline.split_device(
        list(sys.argv[1:] if argv is None else argv))
    run(int(argv[0]) if argv else 60, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
