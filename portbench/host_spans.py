"""Host milliseconds of the port's own spans (deepipr_tpu_torch/utils/
spans.py), read from its ring after the run, for the per-layer metrics of
the two layers above the device: ``train/steps.py``'s step and
``serve.py``'s ``Predictor``.

The window's units are the last ``ctx.window["units"]`` steps
(``train.step``) or requests (``serve.request``) whose spans opened while no
profiler was recording: set-up's come before them, the traced slice's were
recorded under the profiler. So the host's times are those of the untraced
window, where the program runs as it does for a user; the profiler, which
stretches a host's launches, never times them. A reader finds nothing, and
returns None, where the program has no spans, where the ring no longer
holds the whole window, and in a rehearsal on the CPU (no card: a host that
paces plain CPU kernels says nothing of one that paces a card).

How to read the training step's host time: the host blocks while the
card's launch queue is full, so where the card sets the pace (f32 ResNet-18)
a step's host time reads near the device's time a step; where the host
sets the pace (bf16 ResNet-50) it reads the host's own work. Its ratio to
the device's busy time a step says which of the two paces the cell.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

TOP = {"step": "train.step", "request": "serve.request"}
CHILDREN = {
    "step": ("train.input", "train.forward", "train.backward",
             "train.prefix_stats", "train.optimizer"),
    "request": ("serve.stage", "serve.forward", "serve.classes"),
}


def _ms(spans) -> np.ndarray:
    return np.array([(s.end_ns - s.start_ns) / 1e6 for s in spans])


def window(ctx) -> Optional[Dict[str, List]]:
    """The window's top spans (under their name) and each child span of
    theirs by name, in the window's order; None where there is nothing to
    read."""
    if ctx.peaks is None:
        return None
    try:
        from deepipr_tpu_torch.utils import spans
    except ImportError:  # a program without spans
        return None
    ring = spans.records()
    top = TOP[ctx.unit]
    n = ctx.window["units"]
    units = [s for s in ring if s.name == top and not s.profiled]
    if n < 1 or len(units) < n:
        return None
    units = units[-n:]
    # a ring that let spans go holds the whole window only where its oldest
    # span closed before the window's first unit opened
    if spans.dropped() and ring[0].end_ns > units[0].start_ns:
        return None
    ids = {s.id for s in units}
    found = {top: units}
    for s in ring:
        if s.parent in ids:
            found.setdefault(s.name, []).append(s)
    return found


def host_ms(ctx, name: str) -> Optional[float]:
    """The median host milliseconds of span ``name`` a unit of the untraced
    window; notes the count, the 90th percentile and every child span's
    median."""
    found = window(ctx)
    if found is None:
        return None
    n = ctx.window["units"]
    if len(found.get(name, ())) != n:
        return None
    ms = _ms(found[name])
    split = {c: round(float(np.median(_ms(found[c]))), 4)
             for c in CHILDREN[ctx.unit] if c in found}
    ctx.note(f"{ctx.metric}: {name} over {n} {ctx.unit}s of the untraced "
             f"window: median {float(np.median(ms))!r} ms, p90 "
             f"{float(np.percentile(ms, 90))!r} ms; "
             f"{TOP[ctx.unit]} median "
             f"{float(np.median(_ms(found[TOP[ctx.unit]])))!r} ms, its "
             f"children's medians {split}")
    return float(np.median(ms))
