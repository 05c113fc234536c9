"""The benchmark of egobox_torch, the PyTorch and CUDA package, on NVIDIA
GPUs. From the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

One process runs one cell of ``BENCHMARK.json`` on the cards it asks for:
set-up (data from the seed, warm-up), a window of ``--seconds``, then the
check of what the window produced against the plain reference in
``portbench/reference/``. The last line of standard output is the result as
JSON; the numbers compared, each beside its limit, are the last lines of
standard error. ``--trace 1`` reports the per-layer metrics of the cell
from ``torch.profiler`` and the program's counters in place of the
end-to-end ones. Without a CUDA device the run exits with an error and
prints no result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process with few threads: the host's thread pools (OpenMP, MKL,
# OpenBLAS) to one thread each, set before numpy and torch load them
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
