"""BENCHMARK.json's keys, names, units and limits, and the result line's
keys, as the benchmark's contract states them."""

import json
import re

import pytest

from portbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert all(_text(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check with 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _text(c["source"]) and _text(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        body = harness.load_json(harness.ROOT / c["file"])
        assert body["name"] == c["name"] and c["reduced"] == []


def test_workloads():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _text(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert len({w["name"] for w in BENCH["workloads"]}) == len(pairs)


def test_end_to_end():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names and len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"]
                if m["name"] == "setup_s")["bound"] == 0.25


def test_per_layer():
    cells = {w["name"] for w in BENCH["workloads"]}
    names = [m["name"] for m in BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    assert not set(names) & {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == METRIC_KEYS | {"layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _text(m["layer"]) and set(m["workloads"]) <= cells
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    # every cell reports set-up, another end-to-end metric and a per-layer
    for cell in cells:
        c = harness.find_cell(BENCH, cell)
        assert len(c.end_to_end) >= 2 and c.per_layer


def test_result_line(capsys):
    """A rehearsal's last line: the driver's keys, the CPU named, no device
    number, and the numbers compared last, each beside its limit."""
    code = harness.run(["--workload", "r18v2-f32-infer-private-b1024",
                        "--seed", "3000000019", "--seconds", "0.3",
                        "--trace", "1"], 0.0, rehearsal=True)
    assert code == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "cpu"
    assert line["device"]["memory_peak_bytes"] is None
    assert "busy_s" not in line["device"]
    assert line["metrics"] == {}  # every per-layer metric here is a device's
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, check in line["checks"].items():
        assert set(check) == {"value", "limit"}
    tail = out.err.strip().splitlines()
    assert tail[-1].startswith("correct:")
    assert all(t.startswith("check ") for t in tail[-1 - len(
        line["checks"]):-1])


def test_run_refuses_without_a_card(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = harness.run(["--workload", "r18v2-f32-train-b256", "--seed", "1",
                        "--seconds", "1"], 0.0)
    assert code != 0 and capsys.readouterr().out == ""


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (harness.HERE / "traffic").glob("*.json")))
def test_traffic_names_a_driver(name):
    t = harness.load_json(harness.HERE / "traffic" / f"{name}.json")
    assert (harness.HERE / "drivers" / f"{t['driver']}.py").is_file()
    assert t["dtype"] in ("float32", "bfloat16")
    assert set(t["metrics"].values()) <= {m["name"]
                                          for m in BENCH["end_to_end"]}


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    import shutil
    import subprocess
    import sys

    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    for entry in ("portbench/run.py", "portbench/rehearse.py"):
        out = subprocess.run(
            [sys.executable, entry, "--workload", "r18v2-f32-train-b256",
             "--seed", "1", "--seconds", "1"], cwd=tmp_path,
            capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout == ""
