"""``deepipr_tpu_torch/utils/spans.py`` and the spans the port records, on the
CPU.

The span tree and unit ids of a V2 epoch and of ``Predictor`` requests, the
ring's bound, the prefetcher's and the kernel loader's spans, and the mirror
into ``torch.profiler``: under a profiler every span is a host event holding
its children, timed alike; without one no ``record_function`` is entered.
Every test empties the ring first: the tests of one worker process share it.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepipr_tpu_torch.data.prefetch import prefetch
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.ops import cuda_build
from deepipr_tpu_torch.serve import Predictor
from deepipr_tpu_torch.train.epoch import make_epoch_train_fn
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.utils import spans
from deepipr_tpu_torch.utils.config import (
    construct_passport_kwargs,
    load_passport_config,
)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deepipr_tpu_torch"
BATCH, PAD = 4, 4
STEP_CHILDREN = ["train.input", "train.forward", "train.backward",
                 "train.prefix_stats", "train.optimizer"]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread per test, as the other port test files; an empty
    ring."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.reset()
    yield
    torch.set_num_threads(threads)
    spans.reset()


@pytest.fixture(scope="module")
def model():
    """A ResNet18Private V2 model of passport_configs/resnet18_passport.json
    at CIFAR's shapes."""
    torch.manual_seed(0)
    config = load_passport_config(
        str(ROOT / "passport_configs" / "resnet18_passport.json"))
    kwargs, _ = construct_passport_kwargs(config, "bn", "random", 0.1)
    return build_model("resnet18", 10, norm_type="bn", passport_kwargs=kwargs,
                       private=True, input_size=32, device="cpu")


def _epoch(model, steps):
    """``steps`` steps of the V2 epoch function, one call; the state."""
    rng = np.random.default_rng(1)
    images = torch.as_tensor(rng.integers(
        0, 256, (steps * BATCH, 32, 32, 3), dtype=np.uint8))
    labels = torch.as_tensor(rng.integers(0, 10, steps * BATCH))
    state = TrainState.create(model, 0.01)
    epoch_fn = make_epoch_train_fn(model, True, BATCH, PAD, device="cpu")
    state, _ = epoch_fn(state, images, labels, 0)
    return state


def _batch(n=2):
    return np.random.default_rng(2).normal(size=(n, 32, 32, 3)).astype(
        np.float32)


def _children(records, parent):
    return [s for s in records if s.parent == parent.id]


def _by_name(records, name):
    return [s for s in records if s.name == name]


def _under(event):
    """Every host event the profiler nests under ``event``."""
    for c in event.cpu_children:
        yield c
        yield from _under(c)


def test_epoch_span_tree_and_units(model):
    _epoch(model, 2)
    records = spans.records()
    (epoch,) = _by_name(records, "train.epoch")
    assert epoch.parent is None and epoch.unit is None
    kids = _children(records, epoch)
    assert sorted(s.name for s in kids) == [
        "train.metrics", "train.step", "train.step"]
    steps = sorted(_by_name(kids, "train.step"), key=lambda s: s.start_ns)
    assert [s.unit for s in steps] == [0, 1]  # state.step at entry
    for step in steps:
        inner = sorted(_children(records, step), key=lambda s: s.start_ns)
        assert [s.name for s in inner] == STEP_CHILDREN
        for s in inner:
            assert s.unit == step.unit
            assert step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns
            assert not _children(records, s)
    assert steps[1].start_ns >= steps[0].end_ns
    assert all(not s.profiled for s in records)
    # a span closes after its children: the epoch comes last
    assert records[-1] is epoch


def test_predictor_requests_are_units(model):
    pred = Predictor(model, ind=1, device="cpu")
    classes = pred.predict(_batch())
    logits = pred.logits(_batch())
    assert pred.requests == 2
    assert torch.equal(classes, logits.argmax(dim=-1))
    records = spans.records()
    requests = _by_name(records, "serve.request")
    assert [r.unit for r in requests] == [0, 1]
    assert all(r.parent is None for r in requests)
    names = [[s.name for s in sorted(_children(records, r),
                                     key=lambda s: s.start_ns)]
             for r in requests]
    assert names == [["serve.stage", "serve.forward", "serve.classes"],
                     ["serve.stage", "serve.forward"]]
    for r in requests:
        assert all(s.unit == r.unit for s in _children(records, r))
    assert len(records) == 7


def test_ring_bound_and_dropped():
    extra = 10
    for i in range(spans.CAPACITY + extra):
        with spans.span("t", unit=i):
            pass
    records = spans.records()
    assert len(records) == spans.CAPACITY and spans.dropped() == extra
    assert records[0].unit == extra and records[-1].unit == (
        spans.CAPACITY + extra - 1)
    spans.reset()
    assert spans.records() == [] and spans.dropped() == 0


def test_nesting_is_per_thread():
    """A span opened on another thread has no parent there, and inherits
    no unit, whatever this thread has open."""
    import threading

    def inner():
        with spans.span("inner"):
            pass

    with spans.span("outer", unit=7):
        worker = threading.Thread(target=inner)
        worker.start()
        worker.join(30)
        assert not worker.is_alive()
        with spans.span("child") as child:
            pass
    inner, = _by_name(spans.records(), "inner")
    outer, = _by_name(spans.records(), "outer")
    assert inner.parent is None and inner.unit is None
    assert child.parent == outer.id and child.unit == 7


def test_profiler_flag_is_where_spans_read_it():
    """Spans read ``torch.autograd.profiler._is_profiler_enabled`` at each
    open; a torch that moves the flag fails here instead of dropping the
    mirror."""
    flag = "_is_profiler_enabled"
    assert spans._profiler is torch.autograd.profiler
    assert getattr(torch.autograd.profiler, flag) is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert getattr(torch.autograd.profiler, flag) is True
        with spans.span("x") as inside:
            pass
    assert getattr(torch.autograd.profiler, flag) is False
    with spans.span("y") as outside:
        pass
    assert inside.profiled and not outside.profiled


def test_every_span_is_a_profiler_event_around_its_children(model):
    pred = Predictor(model, ind=1, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        pred.predict(_batch())  # warms the mirror's first calls
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pred.predict(_batch())
        _epoch(model, 1)
    records = spans.records()
    assert records and all(s.profiled for s in records)
    events = {}
    for e in prof.events():
        if e.name in {s.name for s in records}:
            events.setdefault(e.name, []).append(e)
    for name in events:
        events[name].sort(key=lambda e: e.time_range.start)
    event_of = {}
    for name in events:
        ring = sorted(_by_name(records, name), key=lambda s: s.start_ns)
        assert len(ring) == len(events[name]), name
        event_of.update({s.id: e for s, e in zip(ring, events[name])})
    for s in records:
        e = event_of[s.id]
        ring_us = (s.end_ns - s.start_ns) / 1e3
        prof_us = e.time_range.end - e.time_range.start
        assert abs(ring_us - prof_us) <= max(0.05 * prof_us, 50.0), s.name
        # the profiler nests the spans as the ring does
        if s.parent is not None:
            assert e.cpu_parent is event_of[s.parent], s.name
        else:
            assert e.cpu_parent is None, s.name
        # and the ATen operations a span ran lie inside its event
        ops = [c for c in _under(e) if c.name.startswith("aten::")]
        assert ops, s.name
        for c in ops:
            assert e.time_range.start <= c.time_range.start
            assert c.time_range.end <= e.time_range.end


def test_no_record_function_without_a_profiler(model, monkeypatch):
    """Spans enter none (torch's own optimizer step enters one always)."""
    real, entered = torch.autograd.profiler.record_function, []

    def record_function(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        record_function)
    Predictor(model, ind=0, device="cpu").predict(_batch())
    _epoch(model, 1)
    records = spans.records()
    assert len(records) == 4 + 2 + 6
    assert not any(s.profiled for s in records)
    assert not {s.name for s in records} & set(entered)
    # the same calls under a profiler enter one for each span
    with profile(activities=[ProfilerActivity.CPU]):
        _epoch(model, 1)
    assert {s.name for s in spans.records()[12:]} <= set(entered)


def test_prefetch_stats_are_its_spans():
    batches = [np.full((2, 3), i, np.float32) for i in range(5)]
    stats = {}
    assert len(list(prefetch(batches, device="cpu", stats=stats))) == 5
    records = spans.records()
    made = _by_name(records, "data.produce")
    staged = _by_name(records, "data.stage")
    # the last produce span is the one that found the source's end
    assert len(made) == 6 and len(staged) == 5
    assert stats["host_s"] == [s.seconds for s in made[:5]]
    assert stats["stage_s"] == [s.seconds for s in staged]
    assert all(s.parent is None for s in made + staged)


@pytest.mark.parametrize("built", [True, False], ids=["compiled", "loaded"])
def test_kernel_load_is_a_span_and_counted(built, monkeypatch):
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build.load, "compiled", {})
    monkeypatch.setattr(cuda_build.load, "loaded", {})
    monkeypatch.setattr(cuda_build, "build", lambda names: {
        n: "nvcc output" for n in names} if built else {})
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: object())
    first = cuda_build.load("fused_augment")
    assert cuda_build.load("fused_augment") is first
    counted = {"fused_augment": 1}
    assert cuda_build.load.compiled == (counted if built else {})
    assert cuda_build.load.loaded == ({} if built else counted)
    assert [s.name for s in spans.records()] == ["ops.kernel_load"]


def test_no_span_name_reads_as_a_kernel(monkeypatch):
    """The benchmark reads device operations by kernel name; no span a
    profiler mirrors may be taken for one."""
    monkeypatch.syspath_prepend(str(ROOT))
    from portbench.readers import BN, CONV

    names = set()
    for path in PORT.rglob("*.py"):
        names |= set(re.findall(r"\bspan\(\s*\"([^\"]+)\"", path.read_text()))
    assert {"train.step", "serve.request", "data.produce",
            "ops.kernel_load"} <= names and len(names) == 15
    for name in names:
        for pattern in (CONV, BN, "fused_augment_kernel",
                        "passport_epilogue_kernel"):
            assert not re.search(pattern, name, re.I), (name, pattern)
