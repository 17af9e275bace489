"""Export a trained passport checkpoint as a folded deployment model.

    python -m deepipr_tpu_torch.cli.export_deployment \
        --ckpt logs/resnet_cifar10_v2/1/models/best.ckpt \
        --arch resnet --num-classes 10 \
        --passport-config passport_configs/resnet18_passport.json \
        --out deploy.ckpt

Counterpart of the repository's ``tools/export_deployment.py``, with its
flags. The artifact is the plain conv+bias architecture with BN and every
affine of branch ``--ind`` folded into the kernels (interop/fold.py): no
passports, no signatures, no BN statistics, the model the paper's workflow
ships to users while the owner keeps the passport checkpoint for
verification (reference README.md:40-61). It is written with
``utils/checkpoint.py::save_model`` (atomic, ``weights_only``-loadable) and
loads with ``load_model`` into ``build_model(arch, num_classes, "none")``.
"""

import argparse


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True, help="full train-state checkpoint")
    p.add_argument("--out", required=True,
                   help="output path for the folded model")
    p.add_argument("--arch", default="resnet",
                   choices=["alexnet", "resnet", "resnet9"])
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--norm-type", default="bn")
    p.add_argument("--key-type", default="shuffle")
    p.add_argument("--sign-loss", type=float, default=0.1)
    p.add_argument("--passport-config",
                   help="passport config JSON; omit for a normal model")
    p.add_argument("--private", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="V2/V3 model; --no-private for a V1 passport "
                        "checkpoint (default: private iff --passport-config "
                        "is given)")
    p.add_argument("--ind", type=int, default=0, choices=[0, 1],
                   help="branch to fold: 0 public/deployment, 1 private")
    p.add_argument("--imgcrop", type=int, default=32)
    return p


def main(argv=None, device="cuda"):
    """Fold on ``device``, write the artifact and print its summary;
    returns the folded model."""
    from deepipr_tpu_torch.cli.common import checkpoint_model, passport_kwargs
    from deepipr_tpu_torch.interop.fold import fold_for_inference
    from deepipr_tpu_torch.interop.jax_params import export_jax_variables
    from deepipr_tpu_torch.utils.checkpoint import save_model

    args = build_parser().parse_args(argv)
    kw = passport_kwargs(args.passport_config, args.norm_type, args.key_type,
                         args.sign_loss)
    private = kw is not None if args.private is None else args.private
    model = checkpoint_model(args.ckpt, args.arch, args.num_classes,
                             args.norm_type, kw, private, args.imgcrop,
                             device, imagenet=args.num_classes == 1000)
    shape = (1, args.imgcrop, args.imgcrop, 3)
    folded = fold_for_inference(model, shape, ind=args.ind)
    save_model(args.out, folded)
    n = sum(t.numel() for t in folded.state_dict().values())
    collections = sorted(export_jax_variables(folded))
    print(f"folded {args.arch} (ind={args.ind}) -> {args.out}: "
          f"{n:,} params, collections={collections} "
          "(no passports/signatures/batch stats)")
    return folded


if __name__ == "__main__":
    main()
