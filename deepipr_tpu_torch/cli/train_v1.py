"""Train baseline (scheme 0) or V1 passport (scheme 1) models on the card.

    python -m deepipr_tpu_torch.cli.train_v1 --arch resnet --dataset synthetic

Counterpart of the repository's ``train_v1.py``: the same flags with the same
defaults and choices (the reference train_v1.py flags plus --dataset
synthetic, --data-root, --seed, --logdir and the rest). It runs on the CUDA
card. ``--transfer-learning`` fine-tunes the --pretrained-path checkpoint
on --tl-dataset and records signature survival (train/transfer.py);
--pretrained-path takes a port checkpoint or a reference or torchvision
.pth/.pt. Flags of paths the port has not reached raise
NotImplementedError naming their ROADMAP item: --multihost, --download,
and the Caltech and ImageNet datasets.
"""

import argparse
from pprint import pprint


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="alexnet",
                   choices=["alexnet", "resnet", "resnet9", "resnet34", "resnet50"],
                   help="architecture (default: alexnet)")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--dataset", default="cifar10",
                   choices=["cifar10", "cifar100", "caltech-101",
                            "caltech-256", "imagenet1000", "synthetic"])
    p.add_argument("--norm-type", default="bn",
                   choices=["bn", "gn", "in", "none"])

    # passport arguments
    p.add_argument("--key-type", choices=["random", "image", "shuffle"],
                   default="shuffle")
    p.add_argument("--sign-loss", type=float, default=0.1)
    p.add_argument("--use-trigger-as-passport", action="store_true",
                   default=False)
    p.add_argument("--separate-stats", action="store_true", default=False,
                   help="V2/V3: per-branch BN running statistics (the "
                        "per-branch-norm DeepIPR variant; the reference "
                        "shares one BN, which can collapse the public "
                        "branch at eval)")

    p.add_argument("--train-passport", action="store_true", default=False)
    p.add_argument("--train-backdoor", action="store_true", default=False)
    p.add_argument("--train-private", action="store_true", default=False)

    # paths
    p.add_argument("--pretrained-path",
                   help="a checkpoint of the port (last.ckpt or best.ckpt), "
                        "or a reference or torchvision .pth/.pt")
    p.add_argument("--lr-config", default="lr_configs/default.json")
    p.add_argument("--passport-config",
                   default="passport_configs/alexnet_passport.json")
    p.add_argument("--trigger-path", default="data/trigger_set/pics")
    p.add_argument("--data-root", default="data")
    p.add_argument("--caltech-split", default="shuffled",
                   choices=["shuffled", "reference"],
                   help="Caltech 80/20 per-class split (Caltech is not "
                        "ported yet)")
    p.add_argument("--download", action="store_true", default=False,
                   help="refused: the port reads local files only")
    p.add_argument("--logdir", default="logs")
    p.add_argument("--workers", type=int, default=16,
                   help="decode threads for the streaming ImageNet loader "
                        "(ImageNet is not ported yet)")
    p.add_argument("--no-draft", dest="draft", action="store_false",
                   default=True,
                   help="disable JPEG draft decode in the streaming loader "
                        "(ImageNet is not ported yet)")
    p.add_argument("--imagenet-cache",
                   help="directory for the resized-uint8 ImageNet decode "
                        "cache (ImageNet is not ported yet)")

    # misc
    p.add_argument("--multihost", action="store_true", default=False,
                   help="multi-process training (not ported yet)")
    p.add_argument("--bf16", action="store_true", default=False,
                   help="bf16 convolutions and normalize path, and a bf16 "
                        "input stage (weights, BN statistics and passport "
                        "derivation stay f32)")
    p.add_argument("--device-augment", action="store_true", default=False,
                   help="run crop/flip/normalize on the card inside the "
                        "train step (kernel K1; the host ships raw uint8 "
                        "batches; V3 triggers are normalized and appended "
                        "on the card)")
    p.add_argument("--epoch-scan", action="store_true", default=False,
                   help="device-resident training: park the dataset on the "
                        "card and run each epoch with kernel K1 in every "
                        "step and one host read at its end (in-memory "
                        "datasets)")
    p.add_argument("--pallas-input", action="store_true", default=False,
                   help="with --epoch-scan: accepted for the JAX package's "
                        "command lines; the port's epoch always runs kernel "
                        "K1, whose batches take the same crops and flips as "
                        "the JAX package's XLA and Pallas input stages and "
                        "normalize to within 1 ulp (atol 3e-7) of either")
    p.add_argument("--ckpt-every", type=int, default=1,
                   help="save last.ckpt every N epochs (default 1 = the "
                        "reference's cadence)")
    p.add_argument("--profile", action="store_true", default=False,
                   help="write a torch.profiler trace of epoch 1 into the "
                        "logdir")
    p.add_argument("--resume", help="full-train-state checkpoint to resume from")
    p.add_argument("--save-interval", type=int, default=0)
    p.add_argument("--eval", action="store_true", default=False)
    p.add_argument("--exp-id", type=int, default=1)
    p.add_argument("--tag")
    p.add_argument("--seed", type=int, default=0)

    # transfer learning
    p.add_argument("--transfer-learning", action="store_true", default=False,
                   help="fine-tune the --pretrained-path checkpoint on "
                        "--tl-dataset and record signature survival per "
                        "epoch (logdir/tl_1/history.csv)")
    p.add_argument("--tl-dataset", default="cifar100",
                   choices=["cifar10", "cifar100", "caltech-101",
                            "caltech-256", "imagenet1000", "synthetic"])
    p.add_argument("--tl-scheme", default="rtal", choices=["rtal", "ftal"])
    return p


def run(args, device="cuda"):
    """Train, evaluate with --eval, or run transfer learning with
    --transfer-learning, as ``args`` (a dict of the parser's values) say;
    returns the experiment."""
    from deepipr_tpu_torch.train.experiment import ClassificationExperiment

    exp = ClassificationExperiment(args, device=device)
    if args["eval"]:
        print(exp.evaluate_only())
    elif exp.is_tl:
        from deepipr_tpu_torch.train.transfer import transfer_learning

        transfer_learning(exp)
    else:
        exp.training()
    print("Training done at", exp.logdir)
    return exp


def main(argv=None, device="cuda", **overrides):
    """Parse ``argv`` (default: the command line) and run. ``overrides``
    set arguments no flag sets (``synthetic_train``, ``synthetic_test``:
    the synthetic set's sizes). Returns the experiment."""
    args = {**vars(build_parser().parse_args(argv)), **overrides}
    pprint(args)
    return run(args, device)


if __name__ == "__main__":
    main()
