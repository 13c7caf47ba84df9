"""The plain reference against closed forms, and against the program on
the CPU (its plain twins) at tiny sizes, through the same calls the
benchmark's window drives."""
import numpy as np

from crdtbench.drivers import packed_of
from crdtbench.gen import OFFSET, chains, rng_for
from crdtbench.reference import check, rga


def _cat(a, b):
    return {k: np.concatenate([a[k], b[k]]) for k in a}


def test_chain_order_is_the_closed_form():
    base, _ = chains.chain_rows(rng_for(1, 1), 16, 0, 30)
    delta, _ = chains.chain_rows(rng_for(1, 2), 16, 30, 20)
    cols = _cat(base, delta)
    out = rga.converge(cols["kind"], cols["ts"], cols["depth"],
                       cols["paths"], len(cols["ts"]))
    want = (np.arange(16, 0, -1)[:, None] * OFFSET
            + np.arange(1, 51)[None, :]).ravel()
    assert np.array_equal(out["order_ts"], want)
    assert np.all(out["status"] == rga.APPLIED)


def test_statuses_of_repeats_and_missing_anchors():
    cols, _ = chains.chain_rows(rng_for(2, 1), 2, 0, 5)
    dup = {k: v[:3] for k, v in cols.items()}
    cols = _cat(cols, dup)
    n = len(cols["ts"])
    cols["paths"] = cols["paths"].copy()
    cols["paths"][4, 0] = 999            # an anchor nobody created
    out = rga.converge(cols["kind"], cols["ts"], cols["depth"],
                       cols["paths"], n)
    assert np.all(out["status"][10:] == rga.ALREADY_APPLIED)
    assert out["status"][4] == rga.NOT_FOUND


def test_catchup_step_matches_the_program():
    from crdt_graph_tpu_torch import engine
    base, bv = chains.chain_rows(rng_for(3, 1), 8, 0, 256)
    delta, dv = chains.chain_rows(rng_for(3, 2), 8, 256, 160)
    tree = engine.TpuTree(65, device="cpu")
    tree.apply_packed(packed_of(base, bv))
    saved = tree.begin_commit()
    tree.apply_packed(packed_of(delta, dv))
    t = tree._table
    cols = _cat(base, delta)
    n = len(cols["ts"])
    got = check.table_view(t.ts.numpy(), t.visible_order.numpy(),
                           t.num_visible.numpy(), t.depth.numpy(),
                           t.parent.numpy(), t.status.numpy(), n)
    assert check.judge(got, cols, n) == {k: 0 for k in check.LIMITS}
    tree.rollback_commit(saved)
    assert tree.log_length == 8 * 256


def test_arrival_order_control_disagrees():
    cols, _ = chains.chain_rows(rng_for(6, 0), 16, 0, 250)
    got = rga.converge(cols["kind"], cols["ts"], cols["depth"],
                       cols["paths"], 4000, sibling_rule="arrival")
    m = check.judge(got, cols, 4000)
    assert m["order_mismatches"] > 0


def test_every_step_builds_the_state_index_again(monkeypatch):
    """A step merges against a state with no timestamp index, as a real
    commit leaves it, so the index is built in every step."""
    from crdt_graph_tpu_torch.codec import packed as packed_mod
    from crdtbench.drivers import catchup
    from crdtbench.tests.conftest import TINY
    cfg = {"replicas": 64, "ops": 0, "local_replica": 65}
    tr = {"delta_ops": [], "checked_steps": 0}
    TINY["rga64x1M.catchup"](cfg, tr)
    drv = catchup.Driver(cfg, tr, 9, "cpu", False)
    drv.setup()
    builds = []
    orig = packed_mod.PackedOps.index

    def counted(self):
        builds.append(self.ts_index is None)
        return orig(self)
    monkeypatch.setattr(packed_mod.PackedOps, "index", counted)
    for p in drv.delta_p[:3]:
        drv.step(p)
    assert builds.count(True) >= 3
