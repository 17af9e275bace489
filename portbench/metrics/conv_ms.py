"""Device milliseconds a step or request of the convolutions' kernels
(cuDNN's and CUTLASS's, with their layout transposes), from the trace, by
kernel name; BN's kernels that cuDNN names are left to bn_ms."""

from portbench.readers import BN, CONV, kernel_ms


def read(ctx):
    return kernel_ms(ctx, CONV, exclude=BN)
