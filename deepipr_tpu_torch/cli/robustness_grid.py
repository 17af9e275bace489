"""The full attack grid against one checkpoint, on the card.

    python -m deepipr_tpu_torch.cli.robustness_grid [ckpt] [arch] [scheme] \
        [cfg] [tag]

Counterpart of the repository's ``tools/run_robustness_grid.sh``, with its
positional arguments and defaults: attack 1 with 50 reps, pruning and flip
from 0 to 100 %, attacks 2 and 3 for 100 epochs at flipperc 0, 0.1, 0.25
and 0.5 (attack 3 on the card-resident set, kernel K1 in every step), and
the forge at those four fractions unless the scheme is 1. Each step runs
in this process through the port CLI's own ``main``; the CSVs land under
``logs/<attack>/<exp>/<id>/`` of the working directory, where
``tools/collect_robustness.py`` reads them. Each step prints its host wall
time and the launches of K1 (``fused_augment``), K2
(``passport_epilogue``) and K2-bwd (``passport_epilogue_backward``) it made.
A step that fails ends the run: there is no retry.
"""

from __future__ import annotations

import importlib
import sys
import time
from typing import Dict, List, Sequence, Tuple

import torch

DEFAULTS = ("logs/resnet_synthetic_v2_demo200/1/models/best.ckpt",
            "resnet18", "2", "passport_configs/resnet18_passport.json", "200")
FLIPPERCS = ("0.0", "0.1", "0.25", "0.5")
FORGE_FLIPPERCS = "0,0.1,0.25,0.5"
# overrides every step takes: the synthetic set's sizes (an attack must see
# the set its checkpoint was trained on)
DATA_OVERRIDES = ("synthetic_train", "synthetic_test")

Step = Tuple[str, List[str]]  # (port CLI module, its argv)


def cli_module(name: str) -> str:
    return f"deepipr_tpu_torch.cli.{name}"


def attack_common(ckpt: str, arch: str, scheme, cfg: str, tag) -> List[str]:
    """The script's ``$COMMON`` flags of every attack."""
    return ["--arch", arch, "--scheme", str(scheme), "--loadpath", ckpt,
            "--passport-config", cfg, "--dataset", "synthetic", "--tagnum",
            str(tag)]


def grid_plan(ckpt: str = DEFAULTS[0], arch: str = DEFAULTS[1],
              scheme=DEFAULTS[2], cfg: str = DEFAULTS[3],
              tag=DEFAULTS[4]) -> List[Step]:
    """The grid's steps in the script's order, one for each of its
    ``python <root script> ...`` lines."""
    common = attack_common(ckpt, arch, scheme, cfg, tag)
    plan = [(cli_module("passport_attack_1"), common + ["--attack-rep",
                                                         "50"]),
            (cli_module("pruning_attack"), common),
            (cli_module("flip_attack"), common)]
    plan += [(cli_module("passport_attack_2"),
              common + ["--flipperc", fp, "--epochs", "100"])
             for fp in FLIPPERCS]
    plan += [(cli_module("passport_attack_3"),
              common + ["--flipperc", fp, "--epochs", "100", "--epoch-scan"])
             for fp in FLIPPERCS]
    if str(scheme) != "1":
        # the forge regresses onto the learned public affine: V2/V3 only
        plan.append((cli_module("passport_forge_attack"),
                     common + ["--flippercs", FORGE_FLIPPERCS]))
    return plan


def launch_counts() -> Dict[str, int]:
    """The launch counters of the three kernels' wrappers."""
    from deepipr_tpu_torch.ops.fused_augment import fused_augment
    from deepipr_tpu_torch.ops.passport_epilogue import (
        passport_epilogue,
        passport_epilogue_backward,
    )

    return {"fused_augment": fused_augment.launches,
            "passport_epilogue": passport_epilogue.launches,
            "passport_epilogue_backward": passport_epilogue_backward.launches}


def run_step(module: str, argv: Sequence[str], device="cuda",
             **overrides) -> Dict:
    """Run one step through its CLI's ``main`` on ``device``. Of
    ``overrides``, the step takes the synthetic set's sizes and those that
    name one of its CLI's flags (``attack_rep``, ``epochs``, ``steps``: cut
    depths). Returns the step's record: module, argv, wall seconds, the
    kernels' launches and what ``main`` returned."""
    cli = importlib.import_module(module)
    dests = {a.dest for a in cli.build_parser()._actions}
    taken = {k: v for k, v in overrides.items()
             if k in DATA_OVERRIDES or k in dests}
    before = launch_counts()
    t = time.perf_counter()
    out = cli.main(list(argv), device=device, **taken)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    print(f"--- {module.rsplit('.', 1)[-1]} {' '.join(argv)}"
          f"{f' {taken}' if taken else ''}: {seconds:.1f} s wall, "
          f"launches {launches}", flush=True)
    return {"module": module, "argv": list(argv), "seconds": seconds,
            "launches": launches, "out": out}


def main(argv=None, device="cuda", **overrides) -> List[Dict]:
    """Run the grid of ``argv`` (the script's positional arguments, default:
    the command line) on ``device``. ``overrides`` set what no flag of the
    script sets: ``synthetic_train`` and ``synthetic_test``, and the cut
    depths ``attack_rep``, ``epochs`` (attacks 2 and 3) and ``steps`` (the
    forge). Returns each step's record (``run_step``)."""
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) > len(DEFAULTS):
        raise SystemExit("usage: robustness_grid [ckpt] [arch] [scheme] "
                         "[cfg] [tag]")
    plan = grid_plan(*args, *DEFAULTS[len(args):])
    records = [run_step(module, step_argv, device, **overrides)
               for module, step_argv in plan]
    print("GRID-DONE", flush=True)
    return records


if __name__ == "__main__":
    main()
