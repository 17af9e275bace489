"""Shared CLI plumbing for the attack scripts (mirrors the reference's
setup blocks in passport_attack_*.py / pruning_attack.py / flip_attack.py).

Counterpart of ``deepipr_tpu/attacks/cli_common.py``: the same flags and
defaults, on the port. The attacked checkpoint is one of the port's
(``utils/checkpoint.py``) or a reference-layout ``.pth``/``.pt``
(``interop/torch_import.py``, the reference attack scripts' own load
path); there is no non-strict load (W8). Models are built on ``device``,
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Dict, List

import torch

from deepipr_tpu_torch.data.datasets import prepare_dataset, prepare_wm
from deepipr_tpu_torch.interop.surgery import copy_matching
from deepipr_tpu_torch.interop.torch_import import load_torch_checkpoint
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.utils.checkpoint import has_separate_stats, load_state
from deepipr_tpu_torch.utils.config import (
    construct_passport_kwargs,
    mark_separate_stats,
)
from deepipr_tpu_torch.utils.device import DeviceLike, resolve_device


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--arch", default="alexnet",
                   choices=["alexnet", "resnet18", "resnet", "resnet9"])
    p.add_argument("--dataset", default="cifar10",
                   choices=["cifar10", "cifar100", "imagenet1000", "synthetic"])
    p.add_argument("--scheme", default=1, choices=[1, 2, 3], type=int)
    p.add_argument("--loadpath", default="", help="checkpoint to attack")
    p.add_argument("--passport-config",
                   default="passport_configs/alexnet_passport.json")
    p.add_argument("--norm-type", default="bn")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--tagnum", default=1, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--data-root", default="data")
    p.add_argument("--separate-stats", action="store_true",
                   help="the attacked checkpoint was trained with per-branch "
                        "BN stats (train CLI --separate-stats)")
    p.add_argument("--trigger-path", default="data/trigger_set/pics",
                   help="V3 trigger set (scheme 3): attacks also report "
                        "black-box WM accuracy per row (the reference's "
                        "trigger-set verification, trainer.py:115-126)")
    return p


def parse(parser: argparse.ArgumentParser, argv, overrides: Dict
          ) -> argparse.Namespace:
    """``parser``'s arguments from ``argv`` (default: the command line),
    with ``overrides`` for what no flag sets (``synthetic_train``,
    ``synthetic_test``: the synthetic set's sizes)."""
    return argparse.Namespace(**{**vars(parser.parse_args(argv)),
                                 **overrides})


def nclass_for(dataset: str) -> int:
    return {"cifar100": 100, "imagenet1000": 1000}.get(dataset, 10)


def _mark_learnable(passport_kwargs: Dict):
    for v in passport_kwargs.values():
        if isinstance(v, dict) and "flag" in v:
            if v["flag"]:
                v["learnable_affine"] = True
        elif isinstance(v, dict):
            _mark_learnable(v)


def load_attacked_model(args, learnable_affine: bool = False,
                        device: DeviceLike = "cuda"):
    """(model, passport_kwargs, plkeys, private, size) for the checkpoint
    under attack; the model, in eval mode on ``device``, holds its weights,
    statistics, passports and signatures (the JAX package returns them as
    a separate ``state``).

    learnable_affine=True rebuilds V1 passport layers with explicit scale/bias
    parameters (the reference's init_scale(True)); the checkpoint — saved
    without them — is loaded into the plain model first, then transplanted.
    """
    dev = resolve_device(device)
    arch = "resnet" if args.arch == "resnet18" else args.arch
    with open(args.passport_config) as f:
        cfg = json.load(f)
    passport_kwargs, plkeys = construct_passport_kwargs(
        cfg, args.norm_type, "shuffle", 0.1
    )
    torch_file = args.loadpath.endswith((".pth", ".pt"))
    separate = bool(getattr(args, "separate_stats", False))
    # a reference file has no per-branch BN statistics
    if args.loadpath and not torch_file and not separate and \
            has_separate_stats(args.loadpath):
        # loading a separate-stats checkpoint into a shared-stats template
        # would fail on the private branch's running stats — enable instead
        print("NOTE: checkpoint carries per-branch BN stats (bn_private); "
              "enabling --separate-stats automatically")
        separate = True
    if separate:
        mark_separate_stats(passport_kwargs)
    private = args.scheme != 1
    nclass = nclass_for(args.dataset)
    size = 224 if args.dataset == "imagenet1000" else 32

    def build(kwargs):
        return build_model(arch, nclass, args.norm_type,
                           passport_kwargs=kwargs, private=private,
                           imagenet=args.dataset == "imagenet1000",
                           input_size=size, device=dev)

    model = build(passport_kwargs)
    if torch_file:
        load_torch_checkpoint(args.loadpath, model)
    elif args.loadpath:
        load_state(args.loadpath, TrainState.create(model, args.lr),
                   restore_opt=False)

    if learnable_affine and not private:
        _mark_learnable(passport_kwargs)
        la_model = build(passport_kwargs)
        with torch.no_grad():
            la_model.load_state_dict(copy_matching(model.state_dict(),
                                                   la_model.state_dict()))
        model = la_model
    for p in model.parameters():
        p.grad = None
    return model, passport_kwargs, plkeys, private, size


def make_loaders(args):
    return prepare_dataset({
        "transfer_learning": False,
        "dataset": args.dataset,
        "tl_dataset": "",
        "batch_size": args.batch_size,
        "data_root": args.data_root,
        "seed": args.seed,
        **{k: getattr(args, k) for k in ("synthetic_train", "synthetic_test")
           if hasattr(args, k)},
    })


def make_wm_loader(args, size: int):
    """V3 black-box verification data: the trigger set, when scheme==3 and
    the WatermarkNN layout is present; else None."""
    if getattr(args, "scheme", None) != 3:
        return None
    try:
        return prepare_wm(args.trigger_path, crop=size, shuffle=False,
                          seed=args.seed)
    except (FileNotFoundError, ValueError) as e:
        # ValueError: a present-but-malformed labels-cifar.txt
        # (np.loadtxt) degrades like the missing-file case
        print(f"WARNING: scheme 3 but no usable trigger set ({e}); "
              "wm_acc columns omitted")
        return None


def write_history_csv(history: List[Dict], dirname: str, filename: str,
                      device: DeviceLike = "cuda"):
    # Stamp backend/device provenance into every row (``cuda:<card name>``
    # or ``cpu``): the canonical robustness record must say what hardware
    # each cell ran on
    dev = torch.device(device)
    backend = (f"cuda:{torch.cuda.get_device_name(dev)}"
               if dev.type == "cuda" else dev.type)
    for row in history:
        row.setdefault("backend", backend)
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, filename)
    cols = sorted({k for row in history for k in row})
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for row in history:
            w.writerow([row.get(c, "") for c in cols])
    print("history written to", path)


def attack_logdir(kind: str, loadpath: str) -> str:
    parts = loadpath.split("/")
    mid = "/".join(parts[1:3]) if len(parts) >= 3 else "run"
    return f"logs/{kind}/{mid}"
