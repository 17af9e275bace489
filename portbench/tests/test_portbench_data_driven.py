"""A later cell, traffic mix and per-layer metric are files and entries
added beside the benchmark's: the harness runs them with no edit to a file
it already has (portbench/rehearse.py, in a copy)."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent

METRIC = '''"""Steps in the traced slice (a counter of the harness)."""


def read(ctx):
    return None if ctx.trace is None else float(ctx.trace.units)
'''


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_added_cell_runs_unedited(tmp_path):
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    os.symlink(ROOT / "deepipr_tpu_torch", tmp_path / "deepipr_tpu_torch")
    before = _digests(tmp_path / "portbench")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cell, traffic = "r18v2-f32-train-b64", "train-b64-f32"
    bench["workloads"].append({
        "name": cell, "config": "resnet18-private-v2-cifar10",
        "traffic": traffic, "chips": 1, "why": "the record's batch"})
    bench["end_to_end"][0]["workloads"].append(cell)
    bench["per_layer"].append({
        "name": "steps_traced.train", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "harness loop",
        "moves": "train_img_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = tmp_path / "portbench"
    spec = json.loads((pb / "traffic" / "train-b256-f32.json").read_text())
    (pb / "traffic" / f"{traffic}.json").write_text(
        json.dumps({**spec, "batch": 64}))
    (pb / "limits" / f"{cell}.json").write_text(
        (pb / "limits" / "r18v2-f32-train-b256.json").read_text())
    (pb / "metrics" / "steps_traced.train.py").write_text(METRIC)

    out = subprocess.run(
        [sys.executable, "portbench/rehearse.py", "--workload", cell,
         "--seed", "4294967311", "--seconds", "0.2", "--trace", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metrics"]["steps_traced.train"]["value"] > 0
    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before
