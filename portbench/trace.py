"""One traced slice of a run under torch.profiler, reduced to what the
per-layer metrics read.

The slice is a bounded number of steps or requests, short enough that CUPTI
keeps every record; no chrome trace is written. It runs twice:

1. With the device's activity alone (on a card): every number comes from
   this pass. Recording each host operation costs the host more time than
   some steps take, so a pass that recorded them would stretch the slice's
   wall interval and measure the profiler; this one leaves the host's work
   as it is untraced. The wall interval is the host clock from a
   synchronise before the slice to one after it, so idle time at its edges
   counts; device operations are the kernels, copies and fills the trace
   holds, all of which lie inside it.
2. With the host's activity too: only to name what the host was doing in
   the longest idle gaps of that pass (``idle_gaps``), whose lengths are
   that pass's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Tuple

import torch

SPAN = "portbench.slice"
TOP = 10
NAME_CHARS = 160


@dataclass
class TraceSummary:
    units: int  # steps or requests in the slice
    window_s: float  # the slice's wall interval
    busy_s: float = 0.0  # the union of device operations within it
    ops: List[Tuple[str, float]] = field(default_factory=list)  # (name, s)
    device_ops: List[list] = field(default_factory=list)  # top by time
    idle_gaps: List[list] = field(default_factory=list)  # longest, by host op

    def seconds_of(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """(seconds, operations) of the device operations whose name
        ``match`` accepts."""
        hits = [s for name, s in self.ops if match(name)]
        return sum(hits), len(hits)


def traced(fn: Callable[[], int], device: torch.device) -> TraceSummary:
    """Run ``fn`` (which returns its step or request count) twice under the
    profiler and summarize it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (
        lambda: None)

    # pass 1: the device's activity alone (the host's on the CPU, where
    # there is no device and no number is read)
    sync()
    with profile(activities=[ProfilerActivity.CUDA if on_card
                             else ProfilerActivity.CPU]) as prof:
        start = time.perf_counter()
        units = fn()
        sync()
        window_s = time.perf_counter() - start
    summary = TraceSummary(units=units, window_s=window_s)
    intervals, by_name = [], {}
    for e in _device_events(prof.events(), DeviceType):
        seconds = (e.time_range.end - e.time_range.start) / 1e6
        summary.ops.append((e.name, seconds))
        by_name[e.name] = by_name.get(e.name, 0.0) + seconds
        intervals.append((e.time_range.start, e.time_range.end))
    summary.device_ops = [[name[:NAME_CHARS], s] for name, s in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:TOP]]
    summary.busy_s = _union(intervals) / 1e6

    # pass 2: the host's activity too, for what the host did in the gaps
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=activities) as prof:
        with record_function(SPAN):
            fn()
            sync()
    events = prof.events()
    spans = [e for e in events
             if e.name == SPAN and e.device_type == DeviceType.CPU]
    if len(spans) != 1:
        raise RuntimeError(f"the trace holds {len(spans)} slice spans")
    lo, hi = spans[0].time_range.start, spans[0].time_range.end
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name != SPAN]
    # the range a record_function marks on the device's timeline bears the
    # host range's name and is no operation
    host_names = {e.name for e in host} | {SPAN}
    busy = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                  for e in _device_events(events, DeviceType)
                  if e.name not in host_names)
    gaps, cursor = [], lo
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if hi > cursor:
        gaps.append((cursor, hi))
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    summary.idle_gaps = [[_host_at(host, (a + b) / 2), (b - a) / 1e6]
                         for a, b in longest]
    return summary


def _device_events(events, DeviceType):
    """Kernels, copies and fills: the device's events that are not a range
    a ``record_function`` marks on its timeline."""
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _union(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, cursor = 0.0, None
    for a, b in sorted(intervals):
        if cursor is None or a > cursor:
            total += b - a
            cursor = b
        elif b > cursor:
            total += b - cursor
            cursor = b
    return total


def _host_at(host, t: float) -> str:
    """The innermost host operation running at ``t``: of those whose range
    holds it, the one that began last; 'python' where none does."""
    best = None
    for e in host:
        if e.time_range.start <= t <= e.time_range.end and (
                best is None or e.time_range.start > best.time_range.start):
            best = e
    return "python" if best is None else best.name[:NAME_CHARS]
