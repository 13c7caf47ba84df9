"""The port's benchmark runner summary, held to the reference's.

For each of the eight configs (1-2 at their full size, 3-8 from the same
generators with small arguments), under ``hints=None`` and
``"exhaustive"``, with and without an expected visible sequence, the
port's summary function on the CPU (``bench.runner._summary_fn``: the
merge, the v2 fingerprint, the node and visible counts and the order
flag, stacked) must give the same four integers as the reference's
jitted ``_summary_fn`` on the same columns.  Tolerance: exact.
"""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401 — configures JAX for the CPU

from crdt_graph_tpu.bench import runner as jrunner  # noqa: E402
from crdt_graph_tpu.bench import workloads as jworkloads  # noqa: E402
from crdt_graph_tpu.codec import packed as jpacked  # noqa: E402

from crdt_graph_tpu_torch.bench import runner as trunner  # noqa: E402
from crdt_graph_tpu_torch.convert import ops_from_numpy  # noqa: E402
from crdt_graph_tpu_torch.ops import merge as tmerge  # noqa: E402

CPU = torch.device("cpu")


def _mirror(ops):
    return jrunner._mirror_expected(ops)


# config id -> (columns, expected visible sequence), at the test sizes
SMALL = {
    1: lambda: jworkloads.editor_replay(1000),
    2: lambda: jworkloads.two_replica_interleaved(10_000),
    3: lambda: jworkloads.nested_tree(2000),
    4: lambda: jworkloads.tombstone_heavy(1000),
    5: lambda: (jworkloads.chain_workload(64, 4096),
                jworkloads.chain_expected_ts(64, 4096)),
    6: lambda: (jworkloads.descending_chains(16, 512),
                jworkloads.descending_expected_ts(16, 512)),
    7: lambda: (jworkloads.comb_pairs(512),
                jworkloads.comb_expected_ts(512)),
    8: lambda: (jworkloads.deep_paths(4, 403),
                jworkloads.deep_expected_ts(4, 403)),
}


def small_config(cid):
    raw = SMALL[cid]()
    if isinstance(raw, tuple):
        return raw
    return jpacked.pack(raw).arrays(), _mirror(raw)


@pytest.mark.parametrize("with_expected", [False, True],
                         ids=["no_expected", "order_check"])
@pytest.mark.parametrize("hints", [None, "exhaustive"])
@pytest.mark.parametrize("cid", sorted(SMALL))
def test_summary_equals_reference(cid, hints, with_expected):
    ops, expected = small_config(cid)
    nd = tmerge.host_no_deletes(np.asarray(ops["kind"]))
    jargs = (ops,) + ((expected,) if with_expected else ())
    want = [int(v) for v in np.asarray(
        jrunner._summary_fn(no_deletes=nd, hints=hints)(*jargs))]
    targs = (ops_from_numpy(ops, CPU),) + (
        (torch.from_numpy(expected),) if with_expected else ())
    got = [int(v) for v in
           trunner._summary_fn(CPU, no_deletes=nd, hints=hints)(*targs)]
    assert got == want
    assert got[3] == 1        # the order check holds (and is 1 without)
