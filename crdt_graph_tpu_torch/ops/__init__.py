"""The merge (``merge.materialize``), its kernels' wrappers and the host
readers of its result (``view``)."""
