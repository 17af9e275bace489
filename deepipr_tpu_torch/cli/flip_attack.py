"""Sign-flipping attack on the card: materialize derived affines, flip p% of
scale signs globally, report accuracy and (passport-derived) signature
detection.

    python -m deepipr_tpu_torch.cli.flip_attack --arch resnet18 --scheme 2 \
        --passport-config passport_configs/resnet18_passport.json \
        --loadpath logs/<run>/models/best.ckpt

Counterpart of the repository's ``flip_attack.py``: the same flags and CSV
(``logs/flipping_attack/...``).
"""

from deepipr_tpu_torch.attacks.cli_common import (
    attack_logdir,
    base_parser,
    load_attacked_model,
    make_loaders,
    make_wm_loader,
    parse,
    write_history_csv,
)


def build_parser():
    p = base_parser("flipping attack: sig. detection & acc after sign flips")
    p.add_argument("--fidxs", default="",
                   help="comma-separated alexnet feature indices to flip "
                        "(default: all passport layers)")
    return p


def main(argv=None, device="cuda", **overrides):
    """Run the attack on ``device``; ``overrides`` set arguments no flag sets
    (``synthetic_train``, ``synthetic_test``). Returns the history rows."""
    from deepipr_tpu_torch.attacks import flip_attack, plkey_to_module_path

    parser = build_parser()
    args = parse(parser, argv, overrides)
    # V1 models need explicit affine params to hold the flipped values
    model, _, plkeys, private, size = load_attacked_model(
        args, learnable_affine=args.scheme == 1, device=device
    )
    _, valloader = make_loaders(args)

    plpaths = [plkey_to_module_path(k) for k in plkeys]
    flip_paths = None
    if args.fidxs:
        if args.arch != "alexnet":
            parser.error("--fidxs only supported for alexnet")
        flip_paths = [f"features_{i}" for i in args.fidxs.split(",")]

    hist = flip_attack(
        model, valloader, (1, size, size, 3), private,
        plpaths=plpaths, seed=args.seed, flip_paths=flip_paths,
        wm_data=make_wm_loader(args, size),
    )
    for row in hist:
        print({k: round(v, 4) if isinstance(v, float) else v
               for k, v in row.items()})
    write_history_csv(
        hist, attack_logdir("flipping_attack", args.loadpath),
        f"{args.arch}-{args.scheme}-history-{args.dataset}-{args.tagnum}.csv",
        device,
    )
    return hist


if __name__ == "__main__":
    main()
