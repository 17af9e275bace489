"""Train a fleet of licensee models on the card (train/ensemble.py).

    python -m deepipr_tpu_torch.cli.train_ensemble --arch alexnet \
        --dataset synthetic --members 4 --signatures "Alice,Bob,Carol,Dave" \
        --epochs 5 --passport-config passport_configs/alexnet_passport.json

Counterpart of the repository's ``tools/train_ensemble.py``, with its flags
and its epoch and member lines. Each member gets its own passports (a
distinct key-selection seed) and its own signature (one ASCII string per
member with --signatures, else the config's or a random one); every step
advances all members on one batch. With --epoch-scan the set is resident on
the card and each epoch takes one augmentation per step for the fleet.
One checkpoint per member lands in --out (``member_<i>.ckpt``, the port's
train-state format), loadable by every port CLI: the attacks,
``verify_ownership``, ``export_deployment``, ``serve_http`` and
``export_torch_checkpoint``.
"""

import argparse
import os
import time


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="alexnet", choices=["alexnet", "resnet"])
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "cifar10", "cifar100"])
    p.add_argument("--data-root", default="data")
    p.add_argument("--members", type=int, default=2)
    p.add_argument("--signatures",
                   help="comma-separated ASCII string per member")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--sign-loss", type=float, default=0.1)
    p.add_argument("--norm-type", default="bn")
    p.add_argument("--key-type", default="shuffle")
    p.add_argument("--passport-config", required=True)
    p.add_argument("--pretrained-path",
                   help="normal-model ckpt whose activations seed the "
                        "passports")
    p.add_argument("--epoch-scan", action="store_true",
                   help="device-resident epochs for the whole fleet: the set "
                        "stays on the card and each step augments once for "
                        "every member")
    p.add_argument("--separate-stats", action="store_true",
                   help="per-branch BN stats: keeps the public branch "
                        "healthy when passports come from an untrained model "
                        "(shared stats diverge in that regime — "
                        "docs/demo/README.md)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="logs/ensemble")
    return p


def main(argv=None, device="cuda", **overrides):
    """Train on ``device``. ``overrides`` set what no flag sets
    (``synthetic_train``, ``synthetic_test``: the synthetic set's sizes).
    Returns {"ensemble": the members' TrainStates, "epochs": each epoch's
    "loss" and lowest per-layer detection "sign" per member and its
    training "seconds" (host clock, ending in the read of its metrics),
    "members": each member's dual-eval metrics and checkpoint path}."""
    import numpy as np

    from deepipr_tpu_torch.cli.common import load_checkpoint, passport_kwargs
    from deepipr_tpu_torch.data.datasets import (
        DataLoader,
        load_cifar,
        normalize,
        synthetic_dataset,
    )
    from deepipr_tpu_torch.models.registry import build_model
    from deepipr_tpu_torch.train.ensemble import (
        ensemble_size,
        init_ensemble,
        make_ensemble_epoch_fn,
        make_ensemble_signature_fn,
        make_ensemble_train_step,
        member_state,
        setup_ensemble_passports,
    )
    from deepipr_tpu_torch.train.epoch import device_resident
    from deepipr_tpu_torch.train.keys import sample_candidates
    from deepipr_tpu_torch.train.steps import make_dual_eval_step, \
        run_dual_eval
    from deepipr_tpu_torch.utils.checkpoint import save_state
    from deepipr_tpu_torch.utils.device import resolve_device

    p = build_parser()
    args = p.parse_args(argv)
    dev = resolve_device(device)
    signatures = None
    if args.signatures:
        signatures = args.signatures.split(",")
        if len(signatures) != args.members:
            p.error(f"--signatures lists {len(signatures)} strings for "
                    f"{args.members} members")

    if args.dataset == "synthetic":
        sizes = {k: overrides[f"synthetic_{k}"] for k in ("train", "test")
                 if f"synthetic_{k}" in overrides}
        xtr, ytr, xte, yte = synthetic_dataset(
            num_train=sizes.get("train", 2048),
            num_test=sizes.get("test", 512), seed=args.seed)
        nclass = 10
    else:
        nclass = 10 if args.dataset == "cifar10" else 100
        xtr, ytr, xte, yte = load_cifar(args.data_root, args.dataset)
    train = DataLoader(xtr, ytr, args.batch_size, shuffle=True,
                       train_augment=True, drop_last=True, seed=args.seed)
    val = DataLoader(xte, yte, args.batch_size)
    if len(train) == 0:
        p.error(f"--batch-size {args.batch_size} exceeds the train set "
                f"({len(xtr)} images with drop_last)")

    kw = passport_kwargs(args.passport_config, args.norm_type, args.key_type,
                         args.sign_loss, args.separate_stats)
    size = xtr.shape[1]

    def member(seed):
        return build_model(args.arch, nclass, args.norm_type,
                           passport_kwargs=kw, private=True, input_size=size,
                           seed=seed, device=dev)

    ens = init_ensemble(member, args.lr, n=args.members, seed=args.seed,
                        signatures=signatures)

    # passports from a pretrained (or fresh) normal model's activations,
    # candidates drawn from the val set (reference classification.py:37-40)
    normal = build_model(args.arch, nclass, args.norm_type, input_size=size,
                         seed=args.seed + 1, device=dev)
    if args.pretrained_path:
        load_checkpoint(args.pretrained_path, normal, args.arch)
    # two independent candidate draws for key/skey, like the runner
    # (train/experiment.py) and the reference's two get_key calls
    # (passport_generator.py:6-17)
    kx = normalize(sample_candidates(xte, 20, args.seed + 10))
    ky = normalize(sample_candidates(xte, 20, args.seed + 11))
    ens = setup_ensemble_passports(ens, normal, kx, ky, seed=args.seed)

    sigfn = make_ensemble_signature_fn((1, size, size, 3), private=True,
                                       device=dev)
    if args.epoch_scan:
        epoch_fn = make_ensemble_epoch_fn(
            ens, True, args.batch_size, pad=int((4 / 32) * size),
            seed=args.seed, device=dev)
        xs, ys = device_resident(xtr, ytr, dev)
    else:
        step = make_ensemble_train_step(ens, private=True, device=dev)

    epochs = []
    for epoch in range(1, args.epochs + 1):
        started = time.perf_counter()
        if args.epoch_scan:
            ens, last = epoch_fn(ens, xs, ys, (args.seed + 100) * 1000 + epoch)
        else:
            last = None
            for batch in train:
                ens, last = step(ens, batch)
        tr = {k: v.cpu().numpy() for k, v in last.items()}
        seconds = time.perf_counter() - started  # the read waited for it
        sig_min = np.stack(list(sigfn(ens).values())).min(axis=0)
        epochs.append({"loss": tr["loss"], "sign": sig_min,
                       "seconds": seconds})
        line = " ".join(
            f"m{i}[loss={tr['loss'][i]:.3f} sign={sig_min[i]:.3f}]"
            for i in range(ensemble_size(ens)))
        print(f"Epoch {epoch:3d} {line}")

    os.makedirs(args.out, exist_ok=True)
    members = []
    for i in range(args.members):
        st = member_state(ens, i)
        res = run_dual_eval(make_dual_eval_step(st.model, device=dev), val)
        path = os.path.join(args.out, f"member_{i}.ckpt")
        save_state(path, st)
        members.append({**res, "path": path})
        tag = f" sig='{signatures[i]}'" if signatures else ""
        print(f"member {i}:{tag} acc_public={res['acc_public']:.2f} "
              f"acc_private={res['acc_private']:.2f} -> {path}")
    return {"ensemble": ens, "epochs": epochs, "members": members}


if __name__ == "__main__":
    main()
