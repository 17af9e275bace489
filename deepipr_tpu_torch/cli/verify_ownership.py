"""White-box ownership verification from the command line, on the card.

    python -m deepipr_tpu_torch.cli.verify_ownership \
        --ckpt logs/resnet_cifar10_v2/1/models/best.ckpt --arch resnet \
        --passport-config passport_configs/resnet18_passport.json

Counterpart of the repository's ``tools/verify_ownership.py``, with its
flags: rebuild the model from its passport config, read the checkpoint,
derive the scales from the passports (K2 on the card) and print per-layer
signature detection rates (with ``--num-chars``, the decoded ASCII) as one
JSON object with sorted keys; exit 0 only when the result is verified. A
counterfeit claim is checked with ``--claimed-ckpt``: that checkpoint's
passports stand in for the model's own (random or optimized fakes land near
50 % detection and fail). ``--commit`` writes a passport pre-commitment
record (passport/commitment.py) to publish before release;
``--check-commitment`` checks the checkpoint against one, written by this
tool or by the JAX package's.
"""

import argparse
import json
import sys


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--arch", default="resnet",
                   choices=["alexnet", "resnet", "resnet9", "resnet50"])
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--norm-type", default="bn")
    p.add_argument("--key-type", default="shuffle")
    p.add_argument("--sign-loss", type=float, default=0.1)
    p.add_argument("--passport-config", required=True)
    p.add_argument("--private", action=argparse.BooleanOptionalAction,
                   default=True, help="V2/V3 model (--no-private for V1)")
    p.add_argument("--separate-stats", action="store_true")
    p.add_argument("--imgcrop", type=int, default=32)
    p.add_argument("--num-chars", type=int,
                   help="decode this many ASCII chars per layer")
    p.add_argument("--claimed-ckpt",
                   help="take the passports from this checkpoint instead "
                        "(verify an adversarial ownership claim)")
    p.add_argument("--commit",
                   help="write a passport pre-commitment record (SHA-256 of "
                        "passports+signatures+derived signs) to this path — "
                        "publish it to timestamp ownership before release "
                        "(passport/commitment.py)")
    p.add_argument("--check-commitment",
                   help="verify the checkpoint against a previously written "
                        "commitment record")
    return p


def main(argv=None, device="cuda"):
    """Verify on ``device`` and print the JSON result; returns it (the
    command exits 0 only when ``result["verified"]``)."""
    from deepipr_tpu_torch.cli.common import checkpoint_model, passport_kwargs
    from deepipr_tpu_torch.passport.commitment import commit, \
        verify_commitment
    from deepipr_tpu_torch.serve import passports, verify_ownership
    from deepipr_tpu_torch.utils.device import resolve_device

    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    kw = passport_kwargs(args.passport_config, args.norm_type, args.key_type,
                         args.sign_loss, args.separate_stats)

    def load(path):
        return checkpoint_model(path, args.arch, args.num_classes,
                                args.norm_type, kw, args.private,
                                args.imgcrop, dev)

    model = load(args.ckpt)
    shape = (1, args.imgcrop, args.imgcrop, 3)
    claimed = passports(load(args.claimed_ckpt)) if args.claimed_ckpt \
        else None

    res = verify_ownership(model, shape, private=args.private,
                           claimed_passports=claimed,
                           num_chars=args.num_chars, device=dev)
    if args.commit:
        rec = commit(model, input_shape=shape, private=args.private)
        with open(args.commit, "w") as f:
            json.dump(rec, f, indent=2, sort_keys=True)
        res["commitment_written"] = args.commit
        res["commitment"] = rec["commitment"]
    if args.check_commitment:
        with open(args.check_commitment) as f:
            rec = json.load(f)
        ok = verify_commitment(model, rec, input_shape=shape,
                               private=args.private)
        res["commitment_valid"] = ok
        res["verified"] = res["verified"] and ok

    print(json.dumps(res, indent=2, sort_keys=True))
    return res


if __name__ == "__main__":
    sys.exit(0 if main()["verified"] else 1)
