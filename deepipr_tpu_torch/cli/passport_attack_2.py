"""Attack 2 on the card — reverse-engineer scale/bias: build a normal model
from the passport checkpoint, flip a fraction of the materialized scale
signs, retrain ONLY those affines.

    python -m deepipr_tpu_torch.cli.passport_attack_2 --arch resnet18 \
        --scheme 2 --passport-config passport_configs/resnet18_passport.json \
        --loadpath logs/<run>/models/best.ckpt --flipperc 0.5 --epochs 10

Counterpart of the repository's ``passport_attack_2.py``: the same flags and
CSV (``logs/passport_attack_2/...``).
"""

from deepipr_tpu_torch.attacks.cli_common import (
    attack_logdir,
    base_parser,
    load_attacked_model,
    make_loaders,
    make_wm_loader,
    nclass_for,
    parse,
    write_history_csv,
)


def build_parser():
    p = base_parser("fake attack 2: reverse engineer passport scale & bias")
    p.add_argument("--rep", default=1, type=int)
    p.add_argument("--flipperc", default=0.0, type=float,
                   help="fraction of signature signs to flip (0..1)")
    p.add_argument("--epochs", type=int, default=None)
    return p


def main(argv=None, device="cuda", **overrides):
    """Run the attack on ``device``; ``overrides`` set arguments no flag sets
    (``synthetic_train``, ``synthetic_test``). Returns the history rows."""
    from deepipr_tpu_torch.attacks import plkey_to_module_path, reverse_attack
    from deepipr_tpu_torch.models.registry import build_model

    args = parse(build_parser(), argv, overrides)
    model, _, plkeys, private, size = load_attacked_model(args, device=device)
    trainloader, valloader = make_loaders(args)

    arch = "resnet" if args.arch == "resnet18" else args.arch
    # reference builds the attacker's model with bn (scheme 1) / gn (private)
    norm = "bn" if args.scheme == 1 else "gn"
    normal = build_model(arch, nclass_for(args.dataset), norm,
                         imagenet=args.dataset == "imagenet1000",
                         input_size=size, seed=args.seed, device=device)

    epochs = args.epochs or (30 if args.dataset == "imagenet1000" else 100)
    plpaths = [plkey_to_module_path(k) for k in plkeys]
    hist = reverse_attack(
        model, normal, trainloader, valloader,
        (1, size, size, 3), private, plpaths,
        flipperc=args.flipperc, epochs=epochs, lr=args.lr, seed=args.seed,
        wm_data=make_wm_loader(args, size),
    )
    for row in hist[-3:]:
        print(row)
    write_history_csv(
        hist, attack_logdir("passport_attack_2", args.loadpath),
        # flipperc in the name so sweeps don't overwrite (the reference's
        # naming, passport_attack_2.py:343, collides across flipperc runs)
        f"{args.arch}-{args.scheme}-history-{args.dataset}-{args.tagnum}-"
        f"{args.flipperc}.csv",
        device,
    )
    return hist


if __name__ == "__main__":
    main()
