"""Forgery/ambiguity attack on the DEPLOYED model, on the card: forge
passports from scratch against a stolen V2 checkpoint — no original
passports, no training data — and sweep the fraction of signature bits the
attacker flips to embed their own identity (attacks/forge.py).

    python -m deepipr_tpu_torch.cli.passport_forge_attack --arch resnet18 \
        --scheme 2 --passport-config passport_configs/resnet18_passport.json \
        --loadpath logs/<run>/models/best.ckpt --flippercs 0,0.5

Counterpart of the repository's ``passport_forge_attack.py``: the same flags
and CSV (``logs/passport_forge_attack/...``), one row per flip fraction:
forged-affine regression quality, the forged signature's bit accuracy, and
the private-branch validation accuracy under the forged passports.
"""

from deepipr_tpu_torch.attacks.cli_common import (
    attack_logdir,
    base_parser,
    load_attacked_model,
    make_loaders,
    parse,
    write_history_csv,
)


def build_parser():
    p = base_parser("forgery attack: forge passports for a stolen model")
    p.add_argument("--flippercs", default="0,0.05,0.1,0.25,0.5,1.0",
                   help="comma-separated signature flip fractions to sweep")
    p.add_argument("--steps", type=int, default=300,
                   help="forgery optimization steps per fraction")
    p.add_argument("--forge-lr", type=float, default=0.05)
    p.add_argument("--refine-epochs", type=int, default=0,
                   help="data-assisted escalation: fine-tune each forgery "
                        "with CE + sign loss for this many epochs over the "
                        "train loader")
    p.add_argument("--refine-data-frac", type=float, default=1.0,
                   help="fraction of the train set the attacker holds")
    return p


def main(argv=None, device="cuda", **overrides):
    """Run the attack on ``device``; ``overrides`` set arguments no flag sets
    (``synthetic_train``, ``synthetic_test``). Returns (the rows, each flip
    fraction's forge history)."""
    from deepipr_tpu_torch.attacks.forge import (
        forge_attack,
        forged_signature_accuracy,
        refine_with_data,
    )
    from deepipr_tpu_torch.data.datasets import DataLoader
    from deepipr_tpu_torch.train.steps import make_eval_step, run_eval

    p = build_parser()
    args = parse(p, argv, overrides)
    if args.scheme == 1:
        p.error("forge attack targets the deployed V2/V3 public affine; "
                "a V1 deployment ships its passports, so the equivalent "
                "threat is attack 3 (passport_attack_3.py)")

    model, _, _, private, size = load_attacked_model(args, device=device)
    trainloader, valloader = make_loaders(args)
    if args.refine_data_frac < 1.0:
        n = max(args.batch_size,
                int(len(trainloader.images) * args.refine_data_frac))
        trainloader = DataLoader(
            trainloader.images[:n], trainloader.labels[:n], args.batch_size,
            shuffle=True, train_augment=True, drop_last=True, seed=args.seed)
    shape = (1, size, size, 3)

    def evaluate(pp=None):
        step = make_eval_step(model, ind=1 if private else 0,
                              force_passport=not private, device=device,
                              tensors=pp)
        return run_eval(step, valloader)

    base = evaluate()
    print(f"owner passports: private acc {base['acc']:.2f}")

    rows, histories = [], []
    for perc in [float(x) for x in args.flippercs.split(",")]:
        forged_pp, attacker_b, hist = forge_attack(
            model, shape, flipperc=perc, steps=args.steps,
            lr=args.forge_lr, seed=args.seed, private=private,
        )
        histories.append(hist)
        res = evaluate(forged_pp)
        sig = forged_signature_accuracy(
            model, forged_pp, attacker_b, shape, private)
        row = {
            "flipperc": perc,
            "forge_mse": hist[-1]["mse"],
            "forged_signacc_vs_attacker_b": round(sig, 4),
            "valid_acc_forged": res["acc"],
            "valid_acc_owner": base["acc"],
        }
        if args.refine_epochs:
            refined_pp, rhist = refine_with_data(
                model, forged_pp, attacker_b, trainloader,
                epochs=args.refine_epochs, private=private)
            row["valid_acc_refined"] = evaluate(refined_pp)["acc"]
            row["refined_signacc"] = round(rhist[-1]["sign_acc"], 4)
        rows.append(row)
        print(row)

    write_history_csv(
        rows, attack_logdir("passport_forge_attack", args.loadpath),
        f"{args.arch}-{args.scheme}-forge-{args.dataset}-{args.tagnum}.csv",
        device,
    )
    return rows, histories


if __name__ == "__main__":
    main()
