"""Faults under the grouped driver's timed path
(``engine.apply_packed_grouped``), each planted with ``monkeypatch``: a
round that returns every state unchanged, half of each delta left out,
an answer altered where the batched merge produces it, and two
documents' slices of the batched table exchanged.  (One chip: no
exchange between chips to leave out.)"""
import dataclasses


def unchanged(monkeypatch):
    from crdt_graph_tpu_torch import engine
    monkeypatch.setattr(engine, "apply_packed_grouped",
                        lambda trees, deltas, **kw: [None] * len(trees))


def half(monkeypatch):
    from crdt_graph_tpu_torch import engine
    from crdt_graph_tpu_torch.codec import packed as packed_mod
    orig = engine.TpuTree.prepare_packed

    def half_merged(self, pnew):
        # the candidate set keeps its rows; the delta's second half
        # becomes padding the merge leaves out
        p = orig(self, pnew)
        if p is pnew:              # a base's own bootstrap
            return p
        kind = p.kind.copy()
        kind[p.num_ops - pnew.num_ops // 2:p.num_ops] = packed_mod.KIND_PAD
        return dataclasses.replace(p, kind=kind, ts_rank=None,
                                   slot_hints=None, ts_index=None)
    monkeypatch.setattr(engine.TpuTree, "prepare_packed", half_merged)


def altered(monkeypatch):
    from crdt_graph_tpu_torch.parallel import mesh
    orig = mesh.batched_materialize

    def swapped(*a, **kw):
        t = orig(*a, **kw)
        t.visible_order = t.visible_order.clone()
        t.visible_order[0, [0, 1]] = t.visible_order[0, [1, 0]]
        return t
    monkeypatch.setattr(mesh, "batched_materialize", swapped)


def swapped(monkeypatch):
    from crdt_graph_tpu_torch.parallel import mesh
    orig = mesh.doc_table

    def other_document(btab, i):
        # documents 0 and 1 commit against each other's slices
        return orig(btab, {0: 1, 1: 0}.get(i, i))
    monkeypatch.setattr(mesh, "doc_table", other_document)


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered,
          "swapped": swapped}
