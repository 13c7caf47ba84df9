"""The comparison fails what it must: the control (the reference with
concurrent siblings in arrival order) at a small size, and whole runs
with the timed path broken underneath: a step that returns its state
unchanged, half of the delta left out, an answer altered where it is
produced.  (One chip: no exchange between chips to leave out.)"""
import dataclasses

import numpy as np
import pytest

from crdtbench import control, run
from crdtbench.tests.conftest import TINY


@pytest.mark.parametrize("seed", (1, 2, 3))
@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_is_not_correct(workload, seed, root):
    got = control.readings(workload, seed, root=root, adjust=TINY[workload])
    assert got["answers"] > 0
    assert got["order_mismatches"] > 0


def _swap_first_two(order):
    order[[0, 1]] = order[[1, 0]]


def _break(monkeypatch, fault):
    from crdt_graph_tpu_torch import engine
    from crdt_graph_tpu_torch.codec import packed as packed_mod
    from crdt_graph_tpu_torch.parallel import opsaxis

    if fault == "unchanged":
        monkeypatch.setattr(engine.TpuTree, "apply_packed",
                            lambda self, p: self)
    elif fault == "half":
        orig = engine.TpuTree.prepare_packed

        def half_merged(self, pnew):
            # the candidate set keeps its rows; the delta's second half
            # becomes padding the merge leaves out
            p = orig(self, pnew)
            if p is pnew:              # the base's own bootstrap
                return p
            kind = p.kind.copy()
            kind[p.num_ops - pnew.num_ops // 2:p.num_ops] = \
                packed_mod.KIND_PAD
            return dataclasses.replace(p, kind=kind, ts_rank=None,
                                       slot_hints=None, ts_index=None)
        monkeypatch.setattr(engine.TpuTree, "prepare_packed", half_merged)
    else:
        orig = opsaxis.routed_materialize

        def altered(*a, **kw):
            t = orig(*a, **kw)
            t.visible_order = t.visible_order.clone()
            _swap_first_two(t.visible_order)
            return t
        monkeypatch.setattr(opsaxis, "routed_materialize", altered)


@pytest.mark.parametrize("fault", ("unchanged", "half", "altered"))
@pytest.mark.parametrize("workload", sorted(TINY))
def test_broken_timed_path_is_not_correct(workload, fault, root,
                                          monkeypatch, capsys):
    import json
    _break(monkeypatch, fault)
    rc = run.main(["--workload", workload, "--seed", "12345",
                   "--seconds", "1", "--trace", "0"],
                  device="cpu", root=root, adjust=TINY[workload])
    out, _ = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
