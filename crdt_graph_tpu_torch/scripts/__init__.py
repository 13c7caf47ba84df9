"""The port's headline entry points, one module for each of the
reference's ``scripts/`` drivers of the serving, durability, fleet,
merge-tier, fan-out, cold-path and ops-axis headlines, and its
``serve_smoke.py`` and ``soak.py``:

    python -m crdt_graph_tpu_torch.scripts.<name> [arguments] [--device cpu]

Each keeps the reference script's ``run(...)`` keywords, its arguments,
its output's keys and its gates, and adds ``device``: the card by
default (it exits non-zero without one), ``--device cpu`` for the plain
path.  Outputs go to ``build/headline/BENCH_<NAME>.json`` under the
checkout and carry the card's name and power limit.  Modules are
imported by name; this package imports none of them."""
