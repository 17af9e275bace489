"""Read the two ends of each compared number's limit, on the card, at a
cell's own size.

    python3 portbench/control.py --workload <cell> --seeds <s> ... \
        [--control-seeds <s> ...] [--fault-seeds <s> ...] [--seconds 2] \
        [--out <file>]

For each of ``--seeds``: the program's run as run.py makes it (set-up, a
short window at the cell's load for serving cells, the reference after)
and every number the comparison computes: the lower readings. For each of
``--control-seeds`` (each one of ``--seeds``): the control, the reference
put in the program's place one precision below the configuration's
(reference/lower.py), against the reference. For each of ``--fault-seeds``:
each fault of faults.py that the cell can have, planted under the timed
path. One JSON line a reading on standard output, and all of them in
``--out``. The benchmark's own runs never run this.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import argparse  # noqa: E402
import json  # noqa: E402

from portbench import faults  # noqa: E402
from portbench.harness import HERE, ROOT, find_cell, import_program, \
    load_json, load_module  # noqa: E402
from portbench.reference.lower import BELOW  # noqa: E402


def _readings(job, seconds: float):
    job.setup()
    if job.unit == "request":
        job.window(seconds)
    job.release()
    return job.reference_readings()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--tiny", action="store_true",
                   help="the driver's tiny sizes (a CPU test)")
    p.add_argument("--out")
    args = p.parse_args(argv)

    cell = find_cell(load_json(ROOT / "BENCHMARK.json"), args.workload)
    import_program()
    from deepipr_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    driver = load_module(HERE / "drivers" / f"{cell.traffic['driver']}.py")
    traffic = {**cell.traffic, **(driver.TINY if args.tiny else {})}
    lower = BELOW[traffic["dtype"]]
    lines = []

    def emit(kind, seed, numbers, started):
        line = {"cell": cell.name, "kind": kind, "seed": seed,
                "seconds": time.perf_counter() - started, "numbers": numbers}
        print(json.dumps(line), flush=True)
        lines.append(line)

    for seed in args.seeds:
        started = time.perf_counter()
        job = driver.Job(cell.config, traffic, seed, device)
        ref = _readings(job, args.seconds)
        emit("program", seed,
             job.compare(job.program_readings(), ref, cell.limits), started)
        if seed in args.control_seeds:
            started = time.perf_counter()
            emit(f"control_{lower.name}", seed,
                 job.compare(job.reference_readings(lower), ref, cell.limits),
                 started)
    for name in faults.for_unit(driver.Job.unit):
        for seed in args.fault_seeds:
            started = time.perf_counter()
            with faults.plant(name):
                job = driver.Job(cell.config, traffic, seed, device)
                ref = _readings(job, args.seconds)
            emit(f"fault_{name}", seed,
                 job.compare(job.program_readings(), ref, cell.limits),
                 started)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
