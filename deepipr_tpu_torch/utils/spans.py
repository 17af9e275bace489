"""Spans: named host intervals at the port's layer boundaries.

A span records its name, its parent (the span open on the same thread when
it opened), a unit id (the training step or the request it serves; a span
opened without one inherits its parent's), its start and end from
``time.perf_counter_ns``, and whether a torch profiler was recording when it
opened. Closed spans go into one bounded ring in memory; ``dropped()``
counts the spans the ring let go to make room.

No profiler recording: a span costs two clock reads and one append, 2-3
microseconds on the host of an H100 machine, under 0.1 % of a training step
or a request of batch 256 or more at 4-8 spans a unit. While a
``torch.profiler`` records, a span also opens
``torch.profiler.record_function`` of its name, so that it lands in the
profiler's host timeline, on the clock of the device's events; the
profiler's trace is the export, and there is no other.

Spans mark layers, not operations: a handful a training step or a request,
never one per model layer.

=====================  =================================================
``train.epoch``        one call of ``epoch_fn`` (train/epoch.py)
``train.metrics``      the epoch's stack and mean of the step metrics
``train.step``         one train step (train/steps.py); unit: ``state.step``
``train.input``        draws, labels, kernel K1's launch, V3's triggers
``train.forward``      both branches' forwards, the CE and the sign loss
``train.backward``     ``backward()`` (a mesh's gradient sum follows it)
``train.prefix_stats`` W3's re-applied EMA of the prefix's BN statistics
``train.optimizer``    ``TrainState.apply_gradients``: lr, SGD, zero_grad
``serve.request``      one ``Predictor.predict`` or ``logits`` call
``serve.stage``        the host batch to an NCHW tensor on the device
``serve.forward``      the model's forward
``serve.classes``      the argmax
``data.produce``       one batch made by the prefetcher's source
``data.stage``         that batch staged and its copy queued
``ops.kernel_load``    a hand-written kernel's library built or loaded
=====================  =================================================
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import List

from torch.autograd import profiler as _profiler

CAPACITY = 65536


class _Local(threading.local):
    def __init__(self):
        self.stack = []  # this thread's open spans, innermost last


_ids = itertools.count()
_local = _Local()
_clock = time.perf_counter_ns
_lock = threading.Lock()
_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0


class Span:
    """One span, open from ``__enter__`` to ``__exit__``; its record once
    closed. ``parent`` is the parent's ``id``, or None."""

    __slots__ = ("id", "name", "parent", "unit", "start_ns", "end_ns",
                 "profiled", "_mirror")

    def __init__(self, name: str, unit=None):
        self.name, self.unit = name, unit
        self.parent = self.start_ns = self.end_ns = self._mirror = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self) -> "Span":
        stack = _local.stack
        if stack:
            up = stack[-1]
            self.parent = up.id
            if self.unit is None:
                self.unit = up.unit
        self.id = next(_ids)
        stack.append(self)
        # each clock read comes just before a call into the mirror, so that
        # the two calls' own costs cancel in the span's duration
        self.start_ns = _clock()
        # read at each open: torch sets this module global while a
        # profiler records
        self.profiled = _profiler._is_profiler_enabled
        if self.profiled:
            self._mirror = _profiler.record_function(self.name)
            self._mirror.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = _clock()
        if self._mirror is not None:
            self._mirror.__exit__(*exc)
            self._mirror = None
        _local.stack.pop()
        global _dropped
        with _lock:
            if len(_ring) == CAPACITY:
                _dropped += 1
            _ring.append(self)


# span(name, unit=None): a context manager recording one span named
# ``name``; ``unit``: the step or request it serves (None: the parent's)
span = Span


def records() -> List[Span]:
    """The ring's closed spans, oldest first (a span closes after its
    children)."""
    with _lock:
        return list(_ring)


def dropped() -> int:
    """Spans the ring let go since the last ``reset``."""
    return _dropped


def reset() -> None:
    """Empty the ring and zero ``dropped``."""
    global _dropped
    with _lock:
        _ring.clear()
        _dropped = 0
