#!/usr/bin/env python3
"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 gpubench/run.py --workload <config>.<traffic> --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the cell's CUDA cards.  The
last line of standard output is the result (JSON); see harness.py."""

import os
import sys
import time

T_START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpubench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
