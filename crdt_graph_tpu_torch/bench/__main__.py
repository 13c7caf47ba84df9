"""``python -m crdt_graph_tpu_torch.bench [--device cpu] [configs]``:
the merge of the benchmark configs timed on the card (``runner.main``);
``... bench headline`` prints config 5 in the reference ``bench.py``'s
one-line shape."""
import sys

from .runner import main

main(sys.argv[1:])
