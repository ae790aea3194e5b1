"""Run one cell of the benchmark of the PyTorch port on a CUDA card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result object; the numbers that decide ``correct`` close standard error.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import bench  # noqa: E402

if __name__ == '__main__':
    sys.exit(bench.main(sys.argv[1:], T_START))
