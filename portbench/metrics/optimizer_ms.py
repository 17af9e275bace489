"""Host milliseconds a step of the optimizer (the ``train.optimizer`` span:
``TrainState.apply_gradients``, the learning rate, SGD's step and
``zero_grad``), median over the untraced window's steps."""

from portbench.host_spans import host_ms


def read(ctx):
    return host_ms(ctx, "train.optimizer")
