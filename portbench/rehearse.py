"""Rehearse one cell of BENCHMARK.json on the CPU, at its driver's tiny
sizes, with the port's plain kernel versions.

    python3 portbench/rehearse.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

The same drivers, readers and comparison as portbench/run.py. Its line
names the CPU and carries no device number: no end-to-end metric, no
memory peak, and only per-layer metrics that are not of the device.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(sys.argv[1:], T0, rehearsal=True))
