"""Export a trained checkpoint as a reference-loadable PyTorch .pth.

    python -m deepipr_tpu_torch.cli.export_torch_checkpoint \
        --ckpt logs/resnet_cifar10_v2/1/models/best.ckpt \
        --arch resnet --num-classes 10 \
        --passport-config passport_configs/resnet18_passport.json \
        --out ours_for_reference.pth

Counterpart of the repository's ``tools/export_torch_checkpoint.py``, with
its flags: a thin CLI over ``interop/torch_export.py::save_torch_checkpoint``.
The state dict loads with strict=True into the reference's own modules
(kamwoh/DeepIPR: AlexNetPassportPrivate, ResNet18Private, ...), so
ownership of a model trained here can be verified in the reference's
PyTorch stack (experiments/trainer_private.py:37-71), and back into the
port with ``interop/torch_import.py``. A separate-stats checkpoint is
refused, as the JAX package refuses it (W6): the reference has no
per-branch BN statistics.
"""

import argparse


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True, help="full train-state checkpoint")
    p.add_argument("--out", required=True, help="output .pth path")
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
    p.add_argument("--imgcrop", type=int, default=32)
    return p


def main(argv=None, device="cuda"):
    """Read the checkpoint on ``device``, write the .pth and print its
    summary; returns the state dict as read back."""
    import torch

    from deepipr_tpu_torch.cli.common import checkpoint_model, passport_kwargs
    from deepipr_tpu_torch.interop.torch_export import save_torch_checkpoint
    from deepipr_tpu_torch.utils.checkpoint import has_separate_stats

    args = build_parser().parse_args(argv)
    # a separate-stats checkpoint loads into a model with bn_private, which
    # the export then refuses (a reference .pth has no per-branch stats)
    separate = not args.ckpt.endswith((".pth", ".pt")) and \
        has_separate_stats(args.ckpt)
    kw = passport_kwargs(args.passport_config, args.norm_type, args.key_type,
                         args.sign_loss, separate)
    private = kw is not None if args.private is None else args.private
    model = checkpoint_model(args.ckpt, args.arch, args.num_classes,
                             args.norm_type, kw, private, args.imgcrop,
                             device)
    save_torch_checkpoint(args.out, model)
    sd = torch.load(args.out, map_location="cpu", weights_only=True)
    n = sum(t.numel() for t in sd.values())
    print(f"exported {args.arch} -> {args.out}: {len(sd)} tensors, "
          f"{n:,} elements, reference PyTorch state-dict layout")
    return sd


if __name__ == "__main__":
    main()
