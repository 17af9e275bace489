"""Command-line entry points of the port: ``python -m
deepipr_tpu_torch.cli.train_v1`` and ``python -m
deepipr_tpu_torch.cli.train_v23``, with the JAX package's flags."""
