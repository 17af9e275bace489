"""The canonical robustness pipeline, on the card.

    python -m deepipr_tpu_torch.cli.canonical_pipeline [--arch resnet] \
        [--passport-config passport_configs/resnet18_passport.json] \
        [--stage LABEL ...]

Counterpart of the repository's ``tools/run_canonical_round5.sh``, stage for
stage and flag for flag: a scheme-0 model trained for 200 epochs; V2, V1
and V3 trained for 200 epochs each with their passport keys propagated
through it (``--pretrained-path``); a random-init V2 control; the full
attack grid (``cli/robustness_grid.py``) on each scheme, V3 on its
``last.ckpt``; the control's attacks 1 and 3; and the six transfer-learning
legs (rtal and ftal from each scheme). Every step runs in this process
through the port CLI's own ``main``, from the working directory, with the
runs under ``logs/`` where the attack CLIs and
``tools/collect_robustness.py`` find them.

The stages carry the script's ``step`` labels; ``--stage`` (repeatable)
runs only those named, in the pipeline's order, so the pipeline can be
split over several calls. The script's paths name each run's id 1, so a
training stage whose ``.../1`` directory exists is refused before anything
runs: a second start on the same ``logs/`` fails instead of writing ``/2``
and attacking a stale ``/1``. A step that fails ends the run: there is no
retry.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

from deepipr_tpu_torch.cli.robustness_grid import (
    DATA_OVERRIDES,
    attack_common,
    cli_module,
    grid_plan,
    run_step,
)

CFG = "passport_configs/resnet18_passport.json"
TAG = "200"
ARCHS = ("resnet", "resnet9", "alexnet")  # those the attack CLIs take


class Stage(NamedTuple):
    label: str  # the script's step line
    kind: str  # "train", "tl" (transfer learning) or "attack"
    steps: List[Tuple[str, List[str]]]  # (port CLI module, argv)
    rundir: Optional[str]  # the run directory a training stage writes


def run_dir(arch: str, scheme: int, tag: str) -> str:
    return f"logs/{arch}_synthetic_v{scheme}_{tag}/1"


def checkpoint(arch: str, scheme: int, tag: str,
               name: str = "best.ckpt") -> str:
    return f"{run_dir(arch, scheme, tag)}/models/{name}"


def pipeline_plan(arch: str = "resnet", cfg: str = CFG) -> List[Stage]:
    """The script's stages in its order."""
    train_v1, train_v23 = cli_module("train_v1"), cli_module("train_v23")
    t = ["--arch", arch, "--dataset", "synthetic", "--batch-size", "64",
         "--passport-config", cfg, "--epoch-scan", "--epochs", "200",
         "--ckpt-every", "20"]
    pre = checkpoint(arch, 0, "demo200pre")

    def train(label, cli, scheme, tag, *flags):
        return Stage(label, "train", [(cli, t + list(flags))],
                     run_dir(arch, scheme, tag))

    stages = [
        train("scheme-0 pretrained (200 ep)", train_v1, 0, "demo200pre",
              "--tag", "demo200pre"),
        train("V2 canonical (pretrained keys)", train_v23, 2, "demo200",
              "--train-private", "--separate-stats", "--tag", "demo200",
              "--pretrained-path", pre),
        train("V1 canonical (pretrained keys)", train_v1, 1, "demo200",
              "--train-passport", "--tag", "demo200", "--pretrained-path",
              pre),
        train("V3 canonical (pretrained keys)", train_v23, 3, "demo200",
              "--train-backdoor", "--separate-stats", "--tag", "demo200",
              "--pretrained-path", pre),
        train("V2 random-init control", train_v23, 2, "demo200ri",
              "--train-private", "--separate-stats", "--tag", "demo200ri"),
    ]
    attack_arch = "resnet18" if arch == "resnet" else arch
    for label, scheme, name in (
            ("V2 attack grid", 2, "best.ckpt"),
            ("V1 attack grid", 1, "best.ckpt"),
            # best-on-validation-accuracy freezes before the trigger set is
            # memorized on the saturating synthetic task
            ("V3 attack grid (last.ckpt)", 3, "last.ckpt")):
        stages.append(Stage(label, "attack", grid_plan(
            checkpoint(arch, scheme, "demo200", name), attack_arch, scheme,
            cfg, TAG), None))
    ri = attack_common(checkpoint(arch, 2, "demo200ri"), attack_arch, 2, cfg,
                       TAG)
    stages.append(Stage(
        "random-init control attacks (key-provenance delta)", "attack",
        [(cli_module("passport_attack_1"), ri + ["--attack-rep", "50"]),
         (cli_module("passport_attack_3"),
          ri + ["--flipperc", "0.0", "--epochs", "100", "--epoch-scan"])],
        None))
    legs = {1: (train_v1, ["--train-passport"], "best.ckpt"),
            2: (train_v23, ["--train-private", "--separate-stats"],
                "best.ckpt"),
            3: (train_v23, ["--train-backdoor", "--separate-stats"],
                "last.ckpt")}
    for scheme, (cli, flags, name) in legs.items():
        for tl in ("rtal", "ftal"):
            tag = f"demo200tl{tl}"
            stages.append(Stage(f"TL v{scheme} {tl}", "tl", [(cli, [
                "--arch", arch, "--dataset", "synthetic", "--batch-size",
                "64", "--passport-config", cfg, *flags,
                "--transfer-learning", "--tl-scheme", tl, "--tl-dataset",
                "synthetic", "--epochs", "50", "--lr-config",
                "lr_configs/finetune.json", "--tag", tag, "--pretrained-path",
                checkpoint(arch, scheme, "demo200", name)])],
                run_dir(arch, scheme, tag)))
    return stages


def build_parser():
    p = argparse.ArgumentParser(
        description="the canonical pipeline: schemes 0-3 trained, the "
                    "attack grid on each, the random-init control, the "
                    "transfer-learning legs")
    p.add_argument("--arch", default="resnet", choices=ARCHS,
                   help="training architecture (the attacks take resnet18 "
                        "for resnet)")
    p.add_argument("--passport-config", default=CFG)
    p.add_argument("--stage", action="append",
                   choices=[s.label for s in pipeline_plan()],
                   help="run only this stage (repeatable; default: all)")
    return p


def main(argv=None, device="cuda", train_epochs: Optional[int] = None,
         tl_epochs: Optional[int] = None, **overrides
         ) -> List[Tuple[str, List[Dict]]]:
    """Run the pipeline (``argv``: default the command line) on ``device``.
    ``train_epochs`` and ``tl_epochs`` cut the script's 200 training and 50
    transfer-learning epochs; ``overrides`` set the synthetic set's sizes
    (``synthetic_train``, ``synthetic_test``) for every step and the
    attacks' cut depths (``robustness_grid.main``). Returns each stage's
    label and its steps' records."""
    args = build_parser().parse_args(argv)
    stages = [s for s in pipeline_plan(args.arch, args.passport_config)
              if not args.stage or s.label in args.stage]
    taken = [s.rundir for s in stages
             if s.rundir and os.path.exists(s.rundir)]
    if taken:
        raise FileExistsError(
            f"run directories exist: {taken}; the pipeline names each run "
            "id 1, so start it on a logs/ without them")
    sizes = {k: v for k, v in overrides.items() if k in DATA_OVERRIDES}
    epochs = {"train": train_epochs, "tl": tl_epochs}
    out = []
    for stage in stages:
        print(f"=== [{time.strftime('%H:%M:%S')}] {stage.label}", flush=True)
        if stage.kind == "attack":
            stage_overrides = overrides
        else:
            stage_overrides = dict(sizes)
            if epochs[stage.kind] is not None:
                stage_overrides["epochs"] = epochs[stage.kind]
        records = [run_step(module, step_argv, device, **stage_overrides)
                   for module, step_argv in stage.steps]
        if stage.rundir:
            logdir = records[-1]["out"].logdir
            if os.path.normpath(logdir) != os.path.normpath(stage.rundir):
                raise RuntimeError(f"{stage.label} wrote {logdir}, not "
                                   f"{stage.rundir}")
        out.append((stage.label, records))
    print("PIPELINE-DONE", flush=True)
    return out


if __name__ == "__main__":
    main()
