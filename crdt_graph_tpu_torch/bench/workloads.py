"""Workload generators for the five BASELINE.json benchmark configs.

Each generator emits a causally valid operation stream shaped like the
config's scenario (anchors always reference earlier-generated nodes, the
way honest replicas behave), either as a Python op list (small sizes, for
oracle cross-checks) or as packed numpy arrays directly (large sizes, so
generation never bottlenecks on Python object churn).

Configs (BASELINE.json `configs`):
1. flat RGA text buffer, 1 replica, 1k add/delete ops (editor replay)
2. 2-replica concurrent flat-list merge, 10k interleaved ops
3. nested tree depth 8, 8-replica merge, add-dominated
4. wide-fanout tree, tombstone-heavy (90% delete), 32 replicas
5. 64-replica × 1M-op batched semilattice join
"""
from __future__ import annotations

import random
from typing import Dict, List

import numpy as np

from ..codec.packed import compute_ts_rank, derive_slot_hints
from ..core.operation import Add, Delete, Operation

OFFSET = 2**32


def _ts(rid: int, counter: int) -> int:
    return rid * OFFSET + counter


def _with_rank(arrs):
    """Attach the ingest rank hint (codec.packed docstring) and the
    derived slot hints (codec.packed.derive_slot_hints) to a raw array
    workload, as every PackedOps producer does — benches exercise the
    same fused exhaustive trace the serving engine dispatches."""
    arrs["ts_rank"] = compute_ts_rank(arrs["kind"], arrs["ts"])
    arrs.update(derive_slot_hints(arrs))
    return arrs


def editor_replay(n_ops: int = 1000, seed: int = 0,
                  append_p: float = 0.75) -> List[Operation]:
    """Config 1: one replica typing into a flat buffer — mostly appends at
    the caret, occasional backspaces (delete of the previous char)."""
    rng = random.Random(seed)
    ops: List[Operation] = []
    counter = 0
    alive: List[int] = []          # timestamps of visible chars, in order
    caret = 0                      # index into alive AFTER which we type
    for _ in range(n_ops):
        if alive and rng.random() >= append_p:
            # backspace at the caret
            k = caret - 1 if caret > 0 else 0
            ops.append(Delete((alive.pop(k),)))
            caret = max(0, caret - 1)
        else:
            counter += 1
            ts = _ts(1, counter)
            anchor = alive[caret - 1] if caret > 0 else 0
            ops.append(Add(ts, (anchor,), chr(97 + counter % 26)))
            alive.insert(caret, ts)
            caret += 1
        # occasionally jump the caret (editing elsewhere)
        if rng.random() < 0.05:
            caret = rng.randrange(len(alive) + 1)
    return ops


def two_replica_interleaved(n_ops: int = 10_000,
                            rounds: int = 50) -> List[Operation]:
    """Config 2: two replicas typing concurrently in bursts, syncing between
    rounds — each round both extend the document at the same point, so the
    merge must interleave burst chains under the RGA rule."""
    per_round = max(1, n_ops // (2 * rounds))
    ops: List[Operation] = []
    counters = [0, 0]
    shared_anchor = 0              # last synced char both replicas see
    for _ in range(rounds):
        round_tails = []
        for r in (0, 1):
            anchor = shared_anchor
            for _ in range(per_round):
                counters[r] += 1
                ts = _ts(r + 1, counters[r])
                ops.append(Add(ts, (anchor,), r))
                anchor = ts
            round_tails.append(anchor)
        # next round both type after replica 1's tail (post-sync caret)
        shared_anchor = round_tails[0]
    return ops


def nested_tree(n_ops: int = 100_000, n_replicas: int = 8,
                depth: int = 8, seed: int = 3) -> List[Operation]:
    """Config 3: depth-``depth`` nested tree, add-dominated.  Replica 1
    builds a nesting skeleton; then all replicas append character chains
    under branches at every level (anchoring at branch sentinels and their
    own previous chars — causally valid without cross-replica anchors)."""
    rng = random.Random(seed)
    ops: List[Operation] = []
    counters = {r: 0 for r in range(1, n_replicas + 1)}

    def stamp(r):
        counters[r] += 1
        return _ts(r, counters[r])

    # skeleton: a chain of nested branches from replica 1
    branch_paths = [()]            # parent paths of available branches
    path: tuple = ()
    for _ in range(depth - 1):
        ts = stamp(1)
        ops.append(Add(ts, path + (0,), "b"))
        path = path + (ts,)
        branch_paths.append(path)
    # bursts: each replica picks a branch and appends a chain under it
    remaining = n_ops - len(ops)
    burst = 64
    while remaining > 0:
        r = rng.randrange(1, n_replicas + 1)
        parent = rng.choice(branch_paths)
        anchor_path = parent + (0,)
        for _ in range(min(burst, remaining)):
            ts = stamp(r)
            ops.append(Add(ts, anchor_path, "x"))
            anchor_path = parent + (ts,)
        remaining -= burst
    return ops


def tombstone_heavy(n_adds: int = 40_000, n_replicas: int = 32,
                    delete_frac: float = 0.9,
                    seed: int = 4) -> List[Operation]:
    """Config 4: wide fanout — every replica appends children directly at
    the root sentinel (maximal sibling concurrency), then deletes 90% of
    its own — the tombstone-chain stress the reference's traversal
    degrades on (SURVEY §3.5)."""
    rng = random.Random(seed)
    ops: List[Operation] = []
    per = n_adds // n_replicas
    for r in range(1, n_replicas + 1):
        for c in range(1, per + 1):
            ops.append(Add(_ts(r, c), (0,), c))
    for r in range(1, n_replicas + 1):
        doomed = rng.sample(range(1, per + 1), int(per * delete_frac))
        ops.extend(Delete((_ts(r, c),)) for c in doomed)
    return ops


def chain_workload(n_replicas: int = 64, n_ops: int = 1_000_000,
                   max_depth: int = 1) -> Dict[str, np.ndarray]:
    """Config 5 (and the bench.py headline): packed arrays for
    ``n_replicas`` interleaved flat insertion chains — every replica
    extends its own chain from the shared branch head, so the merge
    interleaves ``n_replicas`` chains of ``n_ops/n_replicas`` ops each
    under the RGA rule.  Generated vectorized (no Python op objects)."""
    per = n_ops // n_replicas
    n = per * n_replicas
    rid = np.repeat(np.arange(1, n_replicas + 1, dtype=np.int64), per)
    counter = np.tile(np.arange(1, per + 1, dtype=np.int64), n_replicas)
    ts = rid * OFFSET + counter
    anchor = np.where(counter == 1, 0, ts - 1)
    paths = np.zeros((n, max_depth), dtype=np.int64)
    paths[:, 0] = anchor
    idx = np.arange(n, dtype=np.int32)
    return _with_rank({
        "kind": np.zeros(n, dtype=np.int8),           # all adds
        "ts": ts,
        "parent_ts": np.zeros(n, dtype=np.int64),
        "anchor_ts": anchor,
        "depth": np.ones(n, dtype=np.int32),
        "paths": paths,
        "value_ref": idx.copy(),
        "pos": idx.copy(),
        # link hints: each op's anchor is the previous op in its block
        "parent_pos": np.full(n, -1, dtype=np.int32),
        "anchor_pos": np.where(counter == 1, -1, idx - 1).astype(np.int32),
        "target_pos": np.full(n, -1, dtype=np.int32),
    })


def chain_expected_ts(n_replicas: int = 64,
                      n_ops: int = 1_000_000) -> np.ndarray:
    """Closed-form converged visible sequence for :func:`chain_workload`.

    The RGA converged order is the greedy max-timestamp linearisation of
    the anchor forest (ops/merge.py docstring): all chain heads anchor at
    the branch sentinel, so the highest-replica head is emitted first, and
    once emitted its successor (same replica, next counter) outbids every
    other head — each chain runs to completion before the next-highest
    head.  Expected sequence: replicas in DESCENDING id order, each
    replica's ops in counter order.  O(n) numpy; used by bench.py to
    assert the order of the million-op merge, not just its count."""
    per = n_ops // n_replicas
    rids = np.arange(n_replicas, 0, -1, dtype=np.int64)
    counters = np.arange(1, per + 1, dtype=np.int64)
    return (rids[:, None] * OFFSET + counters[None, :]).ravel()


# --- Adversarial kernel workloads (VERDICT round 2, task 3) -------------
#
# Each targets a documented worst case of the merge kernel; all are
# causally valid op streams (anchors reference already-generated nodes).

def descending_chains(n_replicas: int = 4096,
                      n_ops: int = 1_000_000,
                      max_depth: int = 1) -> Dict[str, np.ndarray]:
    """Anchor chains with strictly DESCENDING timestamps — the worst case
    of the nearest-smaller-ancestor chase (ops/merge.py step 9), which
    exits in 0 trips on causal logs but needs its full O(log chain) trips
    here: round j is one chain of ``n_replicas`` ops, replica ids walking
    R, R-1, …, 1, each op anchored at the previous (larger-ts) one.

    Timestamp order is the REVERSE of anchor order within every round, so
    every node's T* parent chase walks to its round's head."""
    per = n_ops // n_replicas          # rounds
    n = per * n_replicas
    rid = np.tile(np.arange(n_replicas, 0, -1, dtype=np.int64), per)
    counter = np.repeat(np.arange(1, per + 1, dtype=np.int64), n_replicas)
    ts = rid * OFFSET + counter
    # within a round, op k anchors at op k-1; round heads anchor at 0
    anchor = np.concatenate([[0], ts[:-1]])
    round_head = np.zeros(n, bool)
    round_head[np.arange(0, n, n_replicas)] = True
    anchor[round_head] = 0
    paths = np.zeros((n, max_depth), dtype=np.int64)
    paths[:, 0] = anchor
    idx = np.arange(n, dtype=np.int32)
    return _with_rank({
        "kind": np.zeros(n, dtype=np.int8),
        "ts": ts,
        "parent_ts": np.zeros(n, dtype=np.int64),
        "anchor_ts": anchor,
        "depth": np.ones(n, dtype=np.int32),
        "paths": paths,
        "value_ref": idx.copy(),
        "pos": idx.copy(),
        "parent_pos": np.full(n, -1, dtype=np.int32),
        "anchor_pos": np.where(round_head, -1, idx - 1).astype(np.int32),
        "target_pos": np.full(n, -1, dtype=np.int32),
    })


def comb_pairs(n_ops: int = 1_000_000,
               max_depth: int = 2) -> Dict[str, np.ndarray]:
    """Tour-fragmentation worst case for the run-contracted list ranking
    (ops/merge.py step 12): ``n_ops/2`` two-node combs — tooth ``a_k``
    (replica 2) anchored at the root sentinel, and ``b_k`` (replica 1,
    smaller timestamp) nested as a BRANCH CHILD of ``a_k`` (path
    ``(a_k, 0)``), so the walk visits ``a_k, b_k, a_{k-1}, b_{k-1}, …``.
    Teeth occupy the upper slot half and children the lower, so the
    Euler tour alternates slot halves every 1-2 tokens: maximal
    ±1-stride runs have length ~1 and Wyllie must run at full 2M width
    for its whole O(log T) trip budget.  (A sibling-anchored ``b_k``
    would NOT fragment: the RGA skip-scan drifts it right past every
    larger-ts tooth and the document collapses to one descending run.)"""
    per = n_ops // 2
    n = per * 2
    k = np.arange(1, per + 1, dtype=np.int64)
    a_ts = 2 * OFFSET + k
    b_ts = 1 * OFFSET + k
    ts = np.empty(n, dtype=np.int64)
    ts[0::2] = a_ts
    ts[1::2] = b_ts
    paths = np.zeros((n, max_depth), dtype=np.int64)
    paths[1::2, 0] = a_ts                 # b's path = (a_k, 0)
    depth = np.ones(n, dtype=np.int32)
    depth[1::2] = 2
    parent_ts = np.zeros(n, dtype=np.int64)
    parent_ts[1::2] = a_ts
    idx = np.arange(n, dtype=np.int32)
    parent_pos = np.full(n, -1, dtype=np.int32)
    parent_pos[1::2] = idx[0::2]
    return _with_rank({
        "kind": np.zeros(n, dtype=np.int8),
        "ts": ts,
        "parent_ts": parent_ts,
        "anchor_ts": np.zeros(n, dtype=np.int64),   # all sentinel-anchored
        "depth": depth,
        "paths": paths,
        "value_ref": idx.copy(),
        "pos": idx.copy(),
        "parent_pos": parent_pos,
        "anchor_pos": np.full(n, -1, dtype=np.int32),
        "target_pos": np.full(n, -1, dtype=np.int32),
    })


def chain_with_deletes(n_adds: int, del_every: int,
                       n_replicas: int = 64) -> Dict[str, np.ndarray]:
    """Mixed vectorized batch: the chain interleave plus a delete of
    every ``del_every``-th node (full wire rows incl. hints) — the
    standard adds+deletes shape for partitioned-merge parity suites."""
    arrs = chain_workload(n_replicas, n_adds)
    n = arrs["kind"].shape[0]
    tgt = np.arange(0, n, del_every, dtype=np.int32)
    m = tgt.size
    cat = np.concatenate
    out = {
        "kind": cat([arrs["kind"], np.ones(m, np.int8)]),
        "ts": cat([arrs["ts"], arrs["ts"][tgt]]),
        "parent_ts": cat([arrs["parent_ts"], np.zeros(m, np.int64)]),
        "anchor_ts": cat([arrs["anchor_ts"], arrs["ts"][tgt]]),
        "depth": cat([arrs["depth"], np.ones(m, np.int32)]),
        "paths": cat([arrs["paths"], arrs["ts"][tgt][:, None]]),
        "value_ref": cat([arrs["value_ref"], np.full(m, -1, np.int32)]),
        "pos": np.arange(n + m, dtype=np.int32),
        "parent_pos": cat([arrs["parent_pos"],
                           np.full(m, -1, np.int32)]),
        "anchor_pos": cat([arrs["anchor_pos"],
                           np.full(m, -1, np.int32)]),
        "target_pos": cat([arrs["target_pos"], tgt]),
    }
    return _with_rank(out)


def deep_paths(n_replicas: int = 64, n_ops: int = 1_000_000,
               max_depth: int = 16) -> Dict[str, np.ndarray]:
    """Maximum-depth stress: replica 1 nests a branch skeleton to
    ``max_depth - 1``, then every replica extends its own chain at the
    deepest branch — every op carries a full 16-element path, exercising
    the widest path-validation compares the kernel supports."""
    skel_ts = np.array([OFFSET + c for c in range(1, max_depth)],
                       dtype=np.int64)
    n_skel = len(skel_ts)
    branch = skel_ts                   # path of the deepest branch
    per = (n_ops - n_skel) // n_replicas
    n = n_skel + per * n_replicas

    kind = np.zeros(n, dtype=np.int8)
    ts = np.empty(n, dtype=np.int64)
    parent_ts = np.zeros(n, dtype=np.int64)
    anchor = np.zeros(n, dtype=np.int64)
    depth = np.empty(n, dtype=np.int32)
    paths = np.zeros((n, max_depth), dtype=np.int64)

    # skeleton: each branch node anchored at its parent's sentinel
    for i in range(n_skel):
        ts[i] = skel_ts[i]
        depth[i] = i + 1
        paths[i, :i] = skel_ts[:i]
        paths[i, i] = 0                # anchor = parent's sentinel
        parent_ts[i] = skel_ts[i - 1] if i else 0
        anchor[i] = 0

    # chains at the deepest branch (replica 1's counters continue past the
    # skeleton so its timestamps stay unique)
    base = np.arange(n_skel, n)
    rid = np.repeat(np.arange(1, n_replicas + 1, dtype=np.int64), per)
    counter = np.tile(np.arange(1, per + 1, dtype=np.int64), n_replicas)
    counter = counter + np.where(rid == 1, n_skel, 0)
    cts = rid * OFFSET + counter
    first = np.tile(np.concatenate([[True], np.zeros(per - 1, bool)]),
                    n_replicas)
    canchor = np.where(first, 0, np.concatenate([[0], cts[:-1]]))
    ts[base] = cts
    parent_ts[base] = branch[-1]
    anchor[base] = canchor
    depth[base] = max_depth
    paths[base, :max_depth - 1] = branch
    paths[base, max_depth - 1] = canchor
    idx = np.arange(n, dtype=np.int32)
    parent_pos = np.full(n, -1, dtype=np.int32)
    parent_pos[1:n_skel] = idx[:n_skel - 1]       # skeleton chains down
    parent_pos[base] = n_skel - 1                 # deepest branch node
    anchor_pos = np.full(n, -1, dtype=np.int32)
    anchor_pos[base] = np.where(first, -1, idx[base] - 1)
    return _with_rank({
        "kind": kind,
        "ts": ts,
        "parent_ts": parent_ts,
        "anchor_ts": anchor,
        "depth": depth,
        "paths": paths,
        "value_ref": idx.copy(),
        "pos": idx.copy(),
        "parent_pos": parent_pos,
        "anchor_pos": anchor_pos,
        "target_pos": np.full(n, -1, dtype=np.int32),
    })


def descending_expected_ts(n_replicas: int = 4096,
                           n_ops: int = 1_000_000) -> np.ndarray:
    """Closed-form visible sequence for :func:`descending_chains`: every
    chain is strictly ts-descending, so each node's T* parent chase
    exhausts at the branch head — the whole document is one flat branch
    ordered by timestamp DESCENDING (greedy max-ts linearisation with
    every op's anchor emitted by the time it is reachable)."""
    return np.sort(descending_chains(n_replicas, n_ops)["ts"])[::-1].copy()


def comb_expected_ts(n_ops: int = 1_000_000) -> np.ndarray:
    """Closed-form visible sequence for :func:`comb_pairs`: teeth sort
    ts-descending at the sentinel; each tooth is immediately followed by
    its (smaller-ts) child."""
    per = n_ops // 2
    k = np.arange(per, 0, -1, dtype=np.int64)
    out = np.empty(2 * per, dtype=np.int64)
    out[0::2] = 2 * OFFSET + k
    out[1::2] = 1 * OFFSET + k
    return out


def deep_expected_ts(n_replicas: int = 64, n_ops: int = 1_000_000,
                     max_depth: int = 16) -> np.ndarray:
    """Closed-form visible sequence for :func:`deep_paths`: pre-order
    walks the skeleton chain, then the chains at the deepest branch
    interleave exactly like :func:`chain_expected_ts` (replica ids
    descending, counters ascending; replica 1's counters continue past
    the skeleton)."""
    n_skel = max_depth - 1
    skel = np.array([OFFSET + c for c in range(1, max_depth)],
                    dtype=np.int64)
    per = (n_ops - n_skel) // n_replicas
    rids = np.arange(n_replicas, 0, -1, dtype=np.int64)
    counters = np.arange(1, per + 1, dtype=np.int64)[None, :] + \
        np.where(rids == 1, n_skel, 0)[:, None]
    return np.concatenate([skel, (rids[:, None] * OFFSET + counters).ravel()])


def unpack_ops(arrs: Dict[str, np.ndarray]) -> List[Operation]:
    """Packed arrays → op list (small sizes only; oracle cross-checks)."""
    out: List[Operation] = []
    for i in range(len(arrs["kind"])):
        d = int(arrs["depth"][i])
        path = tuple(int(x) for x in arrs["paths"][i, :d])
        if int(arrs["kind"][i]) == 0:
            out.append(Add(int(arrs["ts"][i]), path,
                           int(arrs["value_ref"][i])))
        else:
            out.append(Delete(path))
    return out


ADVERSARIAL = {
    "descending_chains_4096rep": descending_chains,
    "comb_pairs_fragmented_tour": comb_pairs,
    "deep_paths_depth16": deep_paths,
}


CONFIGS = {
    1: ("flat_editor_replay_1k", lambda: editor_replay(1000)),
    2: ("two_replica_interleaved_10k",
        lambda: two_replica_interleaved(10_000)),
    3: ("nested_depth8_8rep_100k", lambda: nested_tree(100_000)),
    4: ("tombstone_heavy_32rep", lambda: tombstone_heavy(40_000)),
    5: ("join_64rep_1M", lambda: chain_workload(64, 1_000_000)),
    # adversarial kernel worst cases (ids 6-8; not BASELINE configs)
    6: ("adv_descending_chains_4096rep",
        lambda: descending_chains(4096, 1_000_000)),
    7: ("adv_comb_fragmented_tour", lambda: comb_pairs(1_000_000)),
    8: ("adv_deep_paths_depth16", lambda: deep_paths(64, 1_000_000)),
}
