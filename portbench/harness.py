"""Runs one cell of BENCHMARK.json once and prints its result line.

The cell names its configuration and traffic; the traffic names its driver.
Each is found by name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``drivers/<driver>.py``, ``limits/<cell>.json``, and each per-layer metric
the cell reports ``metrics/<metric>.py``, or where there is no such file
``metrics/<family>.py``, the family being the name before its first dot (a
``read(ctx)`` that returns the value, or None where it finds nothing to
read; ``ctx.metric`` is the metric's full name). A run: set-up (the driver
builds the program and warms every shape the window uses), the window
(``--seconds``), with ``--trace 1`` a traced slice after it, then the
program's state is freed and the reference judges what the timed path
produced. The last lines on standard error are the numbers compared, each
beside its limit; the last line on standard output is the result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROGRAM = "deepipr_tpu_torch"
# top-level modules that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deepipr_tpu")


class CellError(RuntimeError):
    """A cell the benchmark cannot run as asked."""


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark's own, loaded from its file (its name may
    hold dots, as a metric's does)."""
    if not path.is_file():
        raise CellError(f"no file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    workload: Dict
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _reports(metric: Dict, cell: str, default: bool) -> bool:
    names = metric.get("workloads")
    return default if names is None else cell in names


def find_cell(bench: Dict, name: str) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, True)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, m["moves"] in names)]
    return Cell(name=name, workload=w,
                config=load_json(HERE / "configs" / f"{w['config']}.json"),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def reader(name: str):
    """The reader of a per-layer metric: its own file, or its family's."""
    own = HERE / "metrics" / f"{name}.py"
    family = HERE / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(own if own.is_file() else family)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def import_program():
    """The port, from this checkout and nowhere else."""
    sys.path.insert(0, str(ROOT))
    try:
        import deepipr_tpu_torch
    except ImportError as e:
        raise CellError(f"the program {PROGRAM} is not in {ROOT}: {e}")
    where = Path(os.path.abspath(deepipr_tpu_torch.__file__))
    if ROOT not in where.parents:
        raise CellError(f"{PROGRAM} was loaded from {where}, outside {ROOT}")
    return deepipr_tpu_torch


def launch_counts() -> Dict[str, int]:
    """The port's own counters of its hand-written kernels' launches."""
    from deepipr_tpu_torch.ops.fused_augment import fused_augment
    from deepipr_tpu_torch.ops.passport_epilogue import (
        passport_epilogue, passport_epilogue_backward)

    out = {}
    for name, fn in (("fused_augment", fused_augment),
                     ("passport_epilogue", passport_epilogue)):
        for dtype, n in fn.form_launches.items():
            out[f"{name}.{str(dtype).split('.')[-1]}"] = n
    out["passport_epilogue_backward"] = passport_epilogue_backward.launches
    return out


@dataclass
class Context:
    """What a per-layer metric's reader may read."""
    cell: Cell
    unit: str  # the driver's: 'step' or 'request'
    window: Dict
    trace: Optional[object]
    peaks: Optional[Dict]
    metric: str = ""  # the name of the metric being read
    notes: List[str] = field(default_factory=list)

    @property
    def config(self) -> Dict:
        return self.cell.config

    @property
    def traffic(self) -> Dict:
        return self.cell.traffic

    def note(self, text: str) -> None:
        self.notes.append(text)


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e})"


def _cpu_share(seconds: float, cpu_s: float) -> str:
    """This process's CPU time over an interval, in cores: about 1 where
    one host thread paces the device."""
    return (f"this process ran {cpu_s / seconds:.3f} cores of CPU over the "
            f"window")


def run(argv: Optional[List[str]], t0: float, rehearsal: bool = False) -> int:
    """One run of a cell; returns the exit code. ``rehearsal``: on the CPU
    at the drivers' tiny sizes, with the port's plain kernel versions; its
    line names the CPU and carries no device number."""
    args = parse(argv)
    log = lambda *parts: print(*parts, file=sys.stderr, flush=True)
    try:
        cell = find_cell(load_json(ROOT / "BENCHMARK.json"), args.workload)
        import torch

        chips = cell.workload["chips"]
        if not rehearsal and (not torch.cuda.is_available()
                              or torch.cuda.device_count() < chips):
            raise CellError(f"the cell needs {chips} CUDA device(s); "
                            f"available: {torch.cuda.device_count()}")
        import_program()
        from deepipr_tpu_torch.utils.device import resolve_device

        device = resolve_device("cpu" if rehearsal else "cuda:0")
        driver = load_module(HERE / "drivers"
                             / f"{cell.traffic['driver']}.py")
    except CellError as e:
        log(f"portbench: {e}")
        return 2
    if rehearsal:
        cell.traffic = {**cell.traffic, **driver.TINY}
    torch.set_num_threads(4)
    kind = "cpu" if rehearsal else torch.cuda.get_device_name(0)
    log(f"cell {cell.name}: config {cell.workload['config']}, traffic "
        f"{cell.workload['traffic']} {json.dumps(cell.traffic)}; seed "
        f"{args.seed}; device {kind}")

    job = driver.Job(cell.config, cell.traffic, args.seed, device)
    job.setup()
    if device.type == "cuda":
        torch.cuda.synchronize()
    before = launch_counts()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s!r} s: " + json.dumps(job.phases))
    cpu0 = time.process_time()
    window = job.window(args.seconds)
    log(_cpu_share(window["seconds"], time.process_time() - cpu0))
    if "detail" in window:
        log(window["detail"])
    counts = launch_counts()
    log("launches in the window: " + json.dumps(
        {k: counts[k] - before[k] for k in counts}))
    trace = None
    if args.trace:
        clock = time.perf_counter()
        trace = job.trace()
        log(f"traced slice: {trace.units} {job.unit}s in {trace.window_s!r}"
            f" s, device busy {trace.busy_s!r} s; untraced window: "
            f"{window['seconds'] / window['units']!r} s a {job.unit}; both "
            f"passes traced and read in {time.perf_counter() - clock:.1f} s")
        after = launch_counts()
        log("launches in the traced slice: " + json.dumps(
            {k: after[k] - counts[k] for k in counts}))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    if device.type == "cuda":
        log(f"card: {_power_limit()}")
    job.release()
    from portbench.compare import judge

    numbers = job.compare(job.program_readings(), job.reference_readings(),
                          cell.limits)
    correct, checks = judge(numbers, cell.limits)

    metrics = {}
    if not args.trace:
        if not rehearsal:
            # the driver's readings under the names the traffic gives them
            values = {cell.traffic["metrics"][k]: v
                      for k, v in window["metrics"].items()}
            values["setup_s"] = setup_s
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        from portbench.peaks import peaks_for

        ctx = Context(cell=cell, unit=job.unit, window=window, trace=trace,
                      peaks=None if rehearsal else peaks_for(kind))
        for m in cell.per_layer:
            ctx.metric = m["name"]
            value = reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        for text in ctx.notes:
            log(text)
    device_info = {"platform": "cpu" if rehearsal else "gpu", "kind": kind,
                   "count": 1 if rehearsal else cell.workload["chips"],
                   "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics,
              "device": device_info}
    if trace is not None:
        if not rehearsal:
            if trace.busy_s <= 0:
                log("portbench: the trace holds no device operation")
                return 3
            device_info.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.device_ops,
                               "idle_gaps": trace.idle_gaps}
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        log(f"portbench: modules loaded that the run may not load: {found}")
        return 3
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    log(f"correct: {correct}")
    print(json.dumps(result), flush=True)
    return 0
