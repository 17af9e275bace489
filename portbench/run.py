"""Measure one cell of BENCHMARK.json on the card, once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Exits non-zero and prints no result without the CUDA devices the cell asks
for; it never falls back to the CPU (portbench/rehearse.py runs on the
CPU).
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(sys.argv[1:], T0))
