"""Faults under the catch-up driver's timed path
(``TpuTree.apply_packed``), each planted with ``monkeypatch``: a step
that returns its state unchanged, half of the delta left out, an answer
altered where it is produced.  (One chip: no exchange between chips to
leave out.)"""
import dataclasses


def unchanged(monkeypatch):
    from crdt_graph_tpu_torch import engine
    monkeypatch.setattr(engine.TpuTree, "apply_packed", lambda self, p: self)


def half(monkeypatch):
    from crdt_graph_tpu_torch import engine
    from crdt_graph_tpu_torch.codec import packed as packed_mod
    orig = engine.TpuTree.prepare_packed

    def half_merged(self, pnew):
        # the candidate set keeps its rows; the delta's second half
        # becomes padding the merge leaves out
        p = orig(self, pnew)
        if p is pnew:              # the base's own bootstrap
            return p
        kind = p.kind.copy()
        kind[p.num_ops - pnew.num_ops // 2:p.num_ops] = packed_mod.KIND_PAD
        return dataclasses.replace(p, kind=kind, ts_rank=None,
                                   slot_hints=None, ts_index=None)
    monkeypatch.setattr(engine.TpuTree, "prepare_packed", half_merged)


def altered(monkeypatch):
    from crdt_graph_tpu_torch.parallel import opsaxis
    orig = opsaxis.routed_materialize

    def swapped(*a, **kw):
        t = orig(*a, **kw)
        t.visible_order = t.visible_order.clone()
        t.visible_order[[0, 1]] = t.visible_order[[1, 0]]
        return t
    monkeypatch.setattr(opsaxis, "routed_materialize", swapped)


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}
