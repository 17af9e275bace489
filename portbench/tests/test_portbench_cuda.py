"""Each cell on the card, briefly: it runs, comes out correct, and launches
K2 only on the private branch (the port's counters). On the card, from the
repository's root:
``python -m pytest -p no:cacheprovider portbench/tests/test_portbench_cuda.py``
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.counts import k2_shapes

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         "2147483659", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    launches = json.loads(next(
        t for t in out.stderr.splitlines()
        if t.startswith("launches in the window: "))
        .split(": ", 1)[1])
    k2 = launches["passport_epilogue.float32"] \
        + launches["passport_epilogue.bfloat16"]
    cell = harness.find_cell(BENCH, name)
    if cell.traffic["driver"] == "predictor" and cell.traffic["ind"] == 1:
        per_request = len(k2_shapes(cell.config, 1))
        assert k2 == per_request * line["attempted"]
    else:
        assert k2 == 0
