"""Attack 1 on the card — random fake passports: replace the passports with
ones derived from random validation images and watch accuracy collapse.

    python -m deepipr_tpu_torch.cli.passport_attack_1 --arch resnet18 \
        --scheme 2 --passport-config passport_configs/resnet18_passport.json \
        --loadpath logs/<run>/models/best.ckpt --attack-rep 8

Counterpart of the repository's ``passport_attack_1.py``: the same flags and
CSV (``logs/passport_attack_1/...``). The candidate images are the first
four validation batches; the pretrained model that derives the fake
passports is a port checkpoint or a reference or torchvision ``.pth``/``.pt``
(``--pretrained-path``) or, without one, a normal model with random
weights.
"""

import numpy as np

from deepipr_tpu_torch.attacks.cli_common import (
    attack_logdir,
    base_parser,
    load_attacked_model,
    make_loaders,
    nclass_for,
    parse,
    write_history_csv,
)


def build_parser():
    p = base_parser("fake attack 1: random passport")
    p.add_argument("--attack-rep", default=1, type=int)
    p.add_argument("--pretrained-path",
                   help="normal-model ckpt used to derive fake passports "
                        "(a port checkpoint, or a reference or torchvision "
                        ".pth/.pt)")
    return p


def main(argv=None, device="cuda", **overrides):
    """Run the attack on ``device``; ``overrides`` set arguments no flag sets
    (``synthetic_train``, ``synthetic_test``). Returns the history rows."""
    from deepipr_tpu_torch.attacks import random_passport_attack
    from deepipr_tpu_torch.interop.torchvision_import import (
        load_torch_pretrained,
    )
    from deepipr_tpu_torch.models.registry import build_model
    from deepipr_tpu_torch.train.state import TrainState
    from deepipr_tpu_torch.utils.checkpoint import load_state

    args = parse(build_parser(), argv, overrides)
    model, _, _, private, size = load_attacked_model(args, device=device)
    _, valloader = make_loaders(args)

    arch = "resnet" if args.arch == "resnet18" else args.arch
    pretrained = build_model(arch, nclass_for(args.dataset), args.norm_type,
                             imagenet=args.dataset == "imagenet1000",
                             input_size=size, seed=2, device=device)
    if (args.pretrained_path or "").endswith((".pth", ".pt")):
        load_torch_pretrained(args.pretrained_path, pretrained, arch)
    elif args.pretrained_path:
        load_state(args.pretrained_path, TrainState.create(pretrained, 0.0),
                   restore_opt=False)

    cands = np.concatenate([b["image"] for b in valloader][:4])
    hist = random_passport_attack(
        model, pretrained, cands, valloader,
        reps=args.attack_rep, private=private, seed=args.seed,
    )
    for row in hist:
        print(row)
    write_history_csv(
        hist, attack_logdir("passport_attack_1", args.loadpath),
        f"{args.arch}-{args.scheme}-history-{args.dataset}-"
        f"{args.attack_rep}-{args.tagnum}.csv",
        device,
    )
    return hist


if __name__ == "__main__":
    main()
