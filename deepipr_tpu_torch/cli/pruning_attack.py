"""Pruning attack on the card: global magnitude pruning at 0..100%, reporting
signature detection + accuracy.

    python -m deepipr_tpu_torch.cli.pruning_attack --arch resnet18 \
        --scheme 2 --passport-config passport_configs/resnet18_passport.json \
        --loadpath logs/<run>/models/best.ckpt

Counterpart of the repository's ``pruning_attack.py``: the same flags and
CSV (``logs/pruning_attack/...``).
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
    return base_parser("pruning attack: signature detection & acc vs pruning")


def main(argv=None, device="cuda", **overrides):
    """Run the attack on ``device``; ``overrides`` set arguments no flag sets
    (``synthetic_train``, ``synthetic_test``). Returns the history rows."""
    from deepipr_tpu_torch.attacks import pruning_attack

    args = parse(build_parser(), argv, overrides)
    model, _, _, private, size = load_attacked_model(args, device=device)
    _, valloader = make_loaders(args)

    hist = pruning_attack(model, valloader, (1, size, size, 3), private,
                          wm_data=make_wm_loader(args, size))
    for row in hist:
        print({k: round(v, 4) if isinstance(v, float) else v
               for k, v in row.items()})
    write_history_csv(
        hist, attack_logdir("pruning_attack", args.loadpath),
        f"{args.arch}-{args.scheme}-history-{args.dataset}-{args.tagnum}.csv",
        device,
    )
    return hist


if __name__ == "__main__":
    main()
