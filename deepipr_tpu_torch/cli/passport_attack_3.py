"""Attack 3 on the card — ambiguity attack: optimize fake passports with CE +
sign loss + maximize-distance; optionally flip signature bits first.

    python -m deepipr_tpu_torch.cli.passport_attack_3 --arch resnet18 \
        --scheme 2 --passport-config passport_configs/resnet18_passport.json \
        --loadpath logs/<run>/models/best.ckpt --flipperc 0.1 --epochs 10

Counterpart of the repository's ``passport_attack_3.py``: the same flags and
CSV (``logs/passport_attack_3/...``). Every step differentiates the private
forward through kernel K2 and its backward K2-bwd; ``--epoch-scan`` parks
the training set on the card and augments each batch with kernel K1.
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
    p = base_parser("fake attack 3: ambiguity / maximize attack")
    p.add_argument("--rep", default=1, type=int)
    p.add_argument("--flipperc", default=0.0, type=float,
                   help="fraction of signature bits to flip (0..1)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--epoch-scan", action="store_true",
                   help="run each attack epoch on the card-resident set, "
                        "each batch augmented by kernel K1 (in-memory "
                        "datasets)")
    return p


def main(argv=None, device="cuda", **overrides):
    """Run the attack on ``device``; ``overrides`` set arguments no flag sets
    (``synthetic_train``, ``synthetic_test``). Returns the history rows."""
    from deepipr_tpu_torch.attacks import ambiguity_attack
    from deepipr_tpu_torch.train.steps import make_eval_step, run_eval

    args = parse(build_parser(), argv, overrides)
    model, _, _, private, size = load_attacked_model(args, device=device)
    trainloader, valloader = make_loaders(args)
    wm_data = make_wm_loader(args, size)

    def eval_fn(fake_pp):
        # the private (attacked) branch under the FAKE passports
        step = make_eval_step(model, ind=1 if private else 0,
                              force_passport=not private, device=device,
                              tensors=fake_pp)
        out = run_eval(step, valloader)
        row = {f"valid_{k}": v for k, v in out.items()}
        if wm_data is not None:
            # black-box WM check: private (attacked) branch + deployed
            # public branch
            row["wm_acc"] = run_eval(step, wm_data)["acc"]
            public = make_eval_step(model, ind=0, device=device,
                                    tensors=fake_pp)
            row["wm_acc_public"] = run_eval(public, wm_data)["acc"]
        return row

    epochs = args.epochs or (30 if args.dataset == "imagenet1000" else 100)
    _, hist = ambiguity_attack(
        model, trainloader, valloader, epochs=epochs,
        private=private, flipperc=args.flipperc, lr=args.lr,
        seed=args.seed, eval_fn=eval_fn, scan_epochs=args.epoch_scan,
    )
    for row in hist[-3:]:
        print(row)
    write_history_csv(
        hist, attack_logdir("passport_attack_3", args.loadpath),
        f"{args.arch}-{args.scheme}-history-{args.dataset}-{args.rep}-"
        f"{args.tagnum}-{args.flipperc}.csv",
        device,
    )
    return hist


if __name__ == "__main__":
    main()
