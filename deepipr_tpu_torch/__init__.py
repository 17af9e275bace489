"""DeepIPR in PyTorch for NVIDIA Hopper: the CUDA port of ``deepipr_tpu``.

The module layout mirrors ``deepipr_tpu`` so each file has an obvious
counterpart there; ``deepipr_tpu`` stays the reference every module is tested
against. This package imports no JAX and nothing of ``deepipr_tpu``.

Conventions:

- NCHW activations and OIHW conv weights inside; the public entry points
  (``serve.Predictor``, the eval steps, ``verify_ownership``) take NHWC
  batches like their JAX counterparts and permute once at entry.
- Entry points take ``device`` (default ``"cuda"``) and raise when no GPU is
  present unless the caller passes ``device="cpu"``.
- Derived passport affines leave the model as explicit outputs keyed by
  module path (``models.resnet.ResNetOutput.aux``), the counterpart of the
  JAX ``passport_aux`` collection.
- Eval only in this slice: BN uses its running statistics.
"""
