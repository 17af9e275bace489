"""Train V2 (private passport) or V3 (V2 + trigger-set backdoor) models on
the card.

    python -m deepipr_tpu_torch.cli.train_v23 --arch resnet --dataset synthetic

Counterpart of the repository's ``train_v23.py``: the flags of
``cli/train_v1.py``, with --train-private on by default (reference
train_v23.py:42-43).
"""

from pprint import pprint

from deepipr_tpu_torch.cli.train_v1 import build_parser, run


def main(argv=None, device="cuda", **overrides):
    """As ``train_v1.main``, with --train-private on. Returns the
    experiment."""
    p = build_parser()
    p.set_defaults(train_private=True)
    args = {**vars(p.parse_args(argv)), **overrides}
    pprint(args)
    return run(args, device)


if __name__ == "__main__":
    main()
