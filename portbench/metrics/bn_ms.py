"""Device milliseconds a step or request of BatchNorm's kernels
(statistics, transform, backward, and the Welford reductions of the running
statistics), from the trace, by kernel name."""

from portbench.readers import BN, kernel_ms


def read(ctx):
    return kernel_ms(ctx, BN)
