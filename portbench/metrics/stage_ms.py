"""Host milliseconds a request of ``Predictor``'s staging (the ``serve.stage``
span: the NHWC host batch to a contiguous NCHW tensor on the card, through
a pageable copy), median over the untraced window's requests."""

from portbench.host_spans import host_ms


def read(ctx):
    return host_ms(ctx, "serve.stage")
