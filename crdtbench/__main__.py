import os
import sys

# one process with few threads: the host's math libraries run on the
# calling thread (set before numpy or torch is imported)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"

from crdtbench.run import main  # noqa: E402

sys.exit(main())
