"""The control: the reference, put in the program's place one precision
below the configuration's (TF32 for float32, FP8 for bfloat16), comes out
not correct against each cell's limits. At the drivers' tiny sizes on the
CPU; control.py reads it at the cells' own sizes on the card."""

import json

import pytest
import torch

from portbench import control, harness
from portbench.compare import judge
from portbench.reference.lower import FP8, TF32, round_tf32

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, tmp_path):
    out = tmp_path / "readings.jsonl"
    assert control.main(["--workload", name, "--seeds", "3000000003",
                         "--control-seeds", "3000000003", "--device", "cpu",
                         "--tiny", "--seconds", "0.3", "--out",
                         str(out)]) == 0
    lines = [json.loads(t) for t in out.read_text().splitlines()]
    assert [t["kind"] for t in lines][0] == "program"
    limits = harness.find_cell(BENCH, name).limits
    correct, checks = judge(lines[1]["numbers"], limits)
    assert lines[1]["kind"].startswith("control_") and not correct, checks


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.5,
                      1.0 + 2 ** -10])
    want = torch.tensor([1.0, 1.0, 1.0 + 2 ** -9, -1.5, 1.0 + 2 ** -10])
    assert torch.equal(round_tf32(x), want)  # ties to even


def test_fp8_keeps_three_mantissa_bits():
    x = torch.linspace(-3, 3, 1001)
    q = FP8.act(x)
    rel = ((q - x).abs() / x.abs().clamp(min=1e-3))[x.abs() > 0.1]
    assert float(rel.max()) <= 2 ** -4 + 1e-6 and float(rel.max()) > 2 ** -8
    assert TF32.name == "tf32"
