"""DeepIPR in PyTorch for NVIDIA Hopper: the CUDA port of ``deepipr_tpu``.

The module layout mirrors ``deepipr_tpu`` so each file has an obvious
counterpart there; ``deepipr_tpu`` stays the reference every module is tested
against. This package imports no JAX and nothing of ``deepipr_tpu``.

Conventions:

- NCHW activations and OIHW conv weights inside; the public entry points
  (``serve.Predictor``, the train and eval steps, ``verify_ownership``) take
  NHWC batches like their JAX counterparts and permute once at entry.
- Entry points take ``device`` (default ``"cuda"``) and raise when no GPU is
  present unless the caller passes ``device="cpu"``.
- Training (``train/``) puts the model in train mode and leaves it there;
  every eval entry point enters eval mode for the call (utils/mode.py).
- Derived passport affines leave the model as explicit outputs keyed by
  module path (``models.layers.ModelOutput.aux``), the counterpart of the
  JAX ``passport_aux`` collection.
"""
