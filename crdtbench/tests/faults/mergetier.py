"""Faults under the merge tier driver's timed path, each planted with
``monkeypatch`` in the tier's own layers: a commit that leaves the
front-end's state unchanged, a request that ships half of the delta,
an answer altered where the worker reads its epoch back.  (One chip:
no exchange between chips to leave out.)"""
import dataclasses


def unchanged(monkeypatch):
    from crdt_graph_tpu_torch import engine
    monkeypatch.setattr(engine.TpuTree, "finish_packed",
                        lambda self, pnew, p, table: self)


def half(monkeypatch):
    from crdt_graph_tpu_torch.codec import packed as packed_mod
    from crdt_graph_tpu_torch.mergetier import wire
    orig, orig_digest = wire.encode_request, wire.request_digest
    shipped = {}

    def half_shipped(doc_id, p, num_new, trace_meta=None):
        # the candidate set keeps its rows; the delta's second half
        # becomes padding on the wire
        kind = p.kind.copy()
        kind[p.num_ops - num_new // 2:p.num_ops] = packed_mod.KIND_PAD
        shipped[id(p)] = dataclasses.replace(
            p, kind=kind, ts_rank=None, slot_hints=None, ts_index=None)
        return orig(doc_id, shipped[id(p)], num_new, trace_meta=trace_meta)

    def digest_of_shipped(p):
        # the sender's digest is of what it shipped, so the frame passes
        # the tier's own binding and its answer reaches the comparison
        return orig_digest(shipped.get(id(p), p))
    monkeypatch.setattr(wire, "encode_request", half_shipped)
    monkeypatch.setattr(wire, "request_digest", digest_of_shipped)


def altered(monkeypatch):
    from crdt_graph_tpu_torch.mergetier import worker
    orig = worker.read_back

    def swapped(btab):
        tables = orig(btab)
        t = tables[0]
        t.visible_order = t.visible_order.copy()
        t.visible_order[[0, 1]] = t.visible_order[[1, 0]]
        return tables
    monkeypatch.setattr(worker, "read_back", swapped)


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}
