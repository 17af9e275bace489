"""Train/eval mode for the duration of a call.

The JAX package passes ``train=`` to every apply; the port's modules carry a
mode instead. Every eval entry point enters eval mode itself through
``eval_mode``, so a model that a train step left in train mode is evaluated
with its running statistics and none of them changes.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

from torch import nn


@contextlib.contextmanager
def eval_mode(model: nn.Module) -> Iterator[nn.Module]:
    """Put every submodule in eval mode, then restore each one's own mode."""
    modes = [(m, m.training) for m in model.modules()]
    model.eval()
    try:
        yield model
    finally:
        for m, training in modes:
            m.training = training
