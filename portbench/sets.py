"""Run a cell in sets of runs, one process a run, and report each metric's
median and spread: the tool the bounds are set with.

    python3 portbench/sets.py --workload <cell> --seconds <s> \
        --seeds <s> ... [--sets 2] [--trace 0] [--out <file>]

A first run builds what the checkout lacks and is reported apart. Then each
set runs every seed once, in order; every set uses the same seeds. A
spread is the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) over the median. One JSON line a
run on standard output; the summary on standard error.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def run_once(args, seed: int):
    started = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", args.workload,
         "--seed", str(seed), "--seconds", str(args.seconds), "--trace",
         str(args.trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=args.timeout)
    wall = time.perf_counter() - started
    lines = out.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if out.returncode == 0 and lines else None
    return {"seed": seed, "rc": out.returncode, "wall_s": wall,
            "result": result, "stderr_tail": out.stderr[-1500:]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--first-seed", type=int)
    p.add_argument("--timeout", type=float, default=1200)
    p.add_argument("--out")
    args = p.parse_args(argv)
    log = lambda *a: print(*a, file=sys.stderr, flush=True)

    runs = []
    if args.first_seed is not None:
        first = run_once(args, args.first_seed)
        first["set"] = "first"
        runs.append(first)
        print(json.dumps(first), flush=True)
    for k in range(args.sets):
        for seed in args.seeds:
            r = run_once(args, seed)
            r["set"] = k
            runs.append(r)
            print(json.dumps(r), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in runs))

    bad = [r for r in runs if r["result"] is None
           or not r["result"]["correct"]]
    log(f"{args.workload}: {len(runs)} runs, {len(bad)} not correct or "
        f"failed: {[(r['set'], r['seed'], r['rc']) for r in bad]}")
    names = sorted({m for r in runs if r["result"]
                    for m in r["result"]["metrics"]})
    for name in names:
        per_set = []
        for k in range(args.sets):
            values = [r["result"]["metrics"][name]["value"] for r in runs
                      if r["set"] == k and r["result"]
                      and name in r["result"]["metrics"]]
            if len(values) >= 2:
                per_set.append((statistics.median(values), spread(values),
                                values))
        for k, (med, sp, values) in enumerate(per_set):
            log(f"  {name} set {k}: median {med!r} spread {sp!r} "
                f"values {values}")
        if per_set:
            log(f"  {name}: widest spread {max(s for _, s, _ in per_set)!r}"
                f", medians {[m for m, _, _ in per_set]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
