"""crdtbench: the benchmark of the PyTorch/CUDA port
(``crdt_graph_tpu_torch``) on one H100.

``python3 -m crdtbench --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once
(:mod:`crdtbench.run`).  Configurations are ``configs/<config>.json``,
traffic mixes ``traffic/<config>.<mix>.json`` (each naming the driver
in ``drivers/`` that runs it), per-metric readers ``metrics/<metric>.py``,
the plain reference and the check ``reference/``; a cell's CPU test
size ``tests/tiny/<workload>.json`` and its driver's timed-path faults
``tests/faults/<driver>.py``.  A cell is added as such files and entries
appended to ``BENCHMARK.json``.  Nothing here imports JAX or the JAX
package.
"""
