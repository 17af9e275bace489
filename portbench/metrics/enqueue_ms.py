"""Host milliseconds a unit of the port's enqueue, median over the untraced
window: a request's forward (the ``serve.forward`` span of ``Predictor``),
or a whole training step (``train.step``, train/steps.py), by the cell's
unit. Neither waits for the card on purpose; a step's host time reads near
the card's time a step where the card paces the step (the host blocks on
a full launch queue) and the host's own work where the host paces it."""

from portbench.host_spans import host_ms


def read(ctx):
    return host_ms(ctx, "train.step" if ctx.unit == "step"
                   else "serve.forward")
