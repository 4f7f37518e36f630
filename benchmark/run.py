"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cells are BENCHMARK.json's `workloads`.  The run builds or loads the
port's kernels, makes its inputs from the seed, measures the cell's
closed loop for the given seconds, checks what the loop produced against
the plain reference (`benchmark/reference/`) and prints one JSON line:
end-to-end metrics with --trace 0, per-layer metrics from a profiled
stretch with --trace 1.  Without a CUDA card it exits non-zero and prints
no result.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[0:0] = [HERE, os.path.dirname(HERE)]   # the benchmark, the port

from harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(sys.argv[1:], T0))
