"""Reductions that the per-layer metrics' files share: each file in
``metrics/`` picks one and gives it what belongs to that metric alone. A
reader labels what it prints with ``ctx.metric``, the full name of the
metric it is reading (one file serves every metric of its family)."""

from __future__ import annotations

import re
from typing import Optional

from portbench import counts
from portbench.models import DTYPES

SHOWN = 6  # kernel names a metric prints of what its patterns matched


def idle_pct(ctx) -> Optional[float]:
    """The share of the window's wall time in which no device operation
    ran: one less the device's busy time a step or request in the traced
    slice over the untraced window's wall time a step or request. The
    traced slice's own wall is not used: where the host paces the device,
    the profiler's cost on the host (microseconds a launch) stretches it."""
    t, w = ctx.trace, ctx.window
    if t is None or not t.ops:
        return None
    return 100.0 * (1.0 - (t.busy_s / t.units) / (w["seconds"] / w["units"]))


def mfu(ctx) -> Optional[float]:
    """Model FLOPs of the window's steps or requests over its wall time, as
    a share of the compute dtype's dense peak."""
    if ctx.peaks is None:
        return None
    w = ctx.window
    rate = unit_flops(ctx) * w["units"] / w["seconds"]
    return 100.0 * rate / ctx.peaks[ctx.traffic["dtype"]]


def kernel_ms(ctx, match: str, exclude: str = None) -> Optional[float]:
    """Device milliseconds a step or request of the operations whose name
    ``match`` finds and ``exclude`` (if given) does not; prints what they
    were."""
    t = ctx.trace
    if t is None:
        return None
    found = re.compile(match, re.I)
    skip = re.compile(exclude, re.I) if exclude else None
    accept = lambda name: bool(found.search(name)) and not (
        skip and skip.search(name))
    seconds, n = t.seconds_of(accept)
    if n == 0:
        return None
    names = sorted({name for name, _ in t.ops if accept(name)})
    ctx.note(f"{ctx.metric}: {n} operations of {len(names)} kernels matched, "
             f"e.g. {[name[:80] for name in names[:SHOWN]]}")
    return 1e3 * seconds / t.units


def roofline_pct(ctx, kernel: str, bytes_per_launch: float
                 ) -> Optional[float]:
    """The least time the launches of ``kernel`` in the traced slice could
    take at the card's memory bandwidth, over the time they took."""
    t = ctx.trace
    if t is None or ctx.peaks is None:
        return None
    seconds, n = t.seconds_of(lambda name: kernel in name)
    if n == 0:
        return None
    bound = n * bytes_per_launch / ctx.peaks["hbm_bytes_s"]
    ctx.note(f"{ctx.metric}: {n} launches, {seconds!r} s; bound {bound!r} s "
             f"({bytes_per_launch!r} bytes a launch)")
    return 100.0 * bound / seconds


def itemsize(ctx) -> int:
    return DTYPES[ctx.traffic["dtype"]].itemsize


def k1_roofline_pct(ctx) -> Optional[float]:
    """Kernel K1 (ops/fused_augment.py) at the cell's batch."""
    c = ctx.config
    per_launch = counts.k1_bytes(ctx.traffic["batch"], c["input_size"],
                                 c["channels"], itemsize(ctx))
    return roofline_pct(ctx, "fused_augment_kernel", per_launch)


def k2_roofline_pct(ctx) -> Optional[float]:
    """Kernel K2's forward (ops/passport_epilogue.py) at the shapes of the
    private forward's passport blocks, a launch each."""
    shapes = counts.k2_shapes(ctx.config, ctx.traffic["batch"])
    per_launch = sum(counts.k2_bytes(*s, itemsize(ctx))
                     for s in shapes) / len(shapes)
    return roofline_pct(ctx, "passport_epilogue_kernel", per_launch)


def unit_flops(ctx) -> int:
    """Model FLOPs of one step (the split V2 step: prefix once, passport
    suffix once a branch, backward twice the forward) or one request (a
    forward of the traffic's branch)."""
    if ctx.unit == "step":
        return counts.train_step_flops(ctx.config, ctx.traffic["batch"])
    return counts.infer_request_flops(ctx.config, ctx.traffic["batch"],
                                      ctx.traffic["ind"])


# kernel names: cuDNN's and CUTLASS's convolutions and their layout
# transposes; BN's statistics, transform and backward, cuDNN's and ATen's,
# and the Welford reductions of the running statistics
CONV = (r"conv|xmma|cudnn|implicit|fft2d|winograd|flip_filter|nchwToNhwc"
        r"|nhwcToNchw|dgrad|wgrad|fprop|scalePackedTensor")
BN = r"bn_fw|bn_bw|batch_?norm|welford"
