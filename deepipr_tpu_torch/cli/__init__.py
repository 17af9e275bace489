"""Command-line entry points of the port, with the JAX package's flags:
``python -m deepipr_tpu_torch.cli.train_v1`` and ``train_v23`` (training),
``pruning_attack``, ``flip_attack``, ``passport_attack_1``/``_2``/``_3`` and
``passport_forge_attack`` (the attack suite); ``robustness_grid`` and
``canonical_pipeline`` (the repository's robustness record, run through
those CLIs); ``train_ensemble`` (licensee fleets), ``verify_ownership``,
``export_deployment``, ``serve_http`` and ``export_torch_checkpoint`` (the
deployment and dispute tools)."""
