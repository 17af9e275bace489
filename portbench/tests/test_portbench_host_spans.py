"""The readers of the port's spans (metrics/stage_ms.py, enqueue_ms.py,
optimizer_ms.py) on a hand-filled ring: set-up's units, the untraced
window's, then the traced slice's, each read alone as the window's
median."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deepipr_tpu_torch.utils import spans
from portbench import harness

PEAKS = {"float32": 67e12}


class Ring:
    """Spans as the port records them: a unit's children close before it,
    ids rise in the order spans open."""

    def __init__(self):
        self.spans, self.ids, self.clock = [], 0, 0

    def unit(self, top, unit, profiled, children):
        """One unit of span ``top`` whose children last the given ms."""
        opened, self.ids = self.ids, self.ids + 1
        start = self.clock
        for name, ms in children.items():
            self.spans.append(SimpleNamespace(
                id=self.ids, name=name, parent=opened, unit=unit,
                start_ns=self.clock, end_ns=self.clock + int(ms * 1e6),
                profiled=profiled))
            self.ids += 1
            self.clock += int(ms * 1e6)
        self.clock += 1000
        self.spans.append(SimpleNamespace(
            id=opened, name=top, parent=None, unit=unit, start_ns=start,
            end_ns=self.clock, profiled=profiled))


def _ctx(unit, units, metric, peaks=PEAKS):
    ctx = SimpleNamespace(unit=unit, window={"units": units}, peaks=peaks,
                          metric=metric, notes=[])
    ctx.note = ctx.notes.append
    return ctx


def _use(monkeypatch, ring, dropped=0):
    monkeypatch.setattr(spans, "records", lambda: list(ring.spans))
    monkeypatch.setattr(spans, "dropped", lambda: dropped)


def _training_ring():
    """3 set-up steps at 10 ms of optimizer, 5 window steps at 1-5 ms, 4
    traced steps at 20 ms; every other child 1 ms."""
    ring = Ring()
    step = 0
    for profiled, optimizer in ([(False, 10.0)] * 3
                                + [(False, float(k)) for k in (3, 1, 5, 2, 4)]
                                + [(True, 20.0)] * 4):
        ring.unit("train.step", step, profiled, {
            "train.input": 1.0, "train.forward": 1.0, "train.backward": 1.0,
            "train.prefix_stats": 1.0, "train.optimizer": optimizer})
        step += 1
    return ring


def _serving_ring():
    """2 warm-up requests (stage 9 ms), 4 in the window (stage 1-4 ms,
    forward 5-8), 2 traced (stage 30)."""
    ring = Ring()
    plan = ([(False, 9.0, 9.0)] * 2
            + [(False, float(k), float(k + 4)) for k in (4, 1, 3, 2)]
            + [(True, 30.0, 30.0)] * 2)
    for i, (profiled, stage, forward) in enumerate(plan):
        ring.unit("serve.request", i, profiled, {
            "serve.stage": stage, "serve.forward": forward,
            "serve.classes": 0.5})
    return ring


@pytest.mark.parametrize("metric,expected", [
    ("optimizer_ms.train", 3.0),
    ("enqueue_ms.train", 3.0 + 4 + 1e-3),  # its children and 1e-3 ms more
])
def test_training_readers_read_the_window(metric, expected, monkeypatch):
    _use(monkeypatch, _training_ring())
    ctx = _ctx("step", 5, metric)
    assert harness.reader(metric).read(ctx) == pytest.approx(expected)
    assert len(ctx.notes) == 1 and "over 5 steps" in ctx.notes[0]
    assert "'train.backward': 1.0" in ctx.notes[0]


@pytest.mark.parametrize("metric,expected", [
    ("stage_ms.infer", 2.5), ("enqueue_ms.infer", 6.5)])
def test_serving_readers_read_the_window(metric, expected, monkeypatch):
    _use(monkeypatch, _serving_ring())
    ctx = _ctx("request", 4, metric)
    assert harness.reader(metric).read(ctx) == pytest.approx(expected)
    assert "'serve.classes': 0.5" in ctx.notes[0]


@pytest.mark.parametrize("metric", ["stage_ms.infer", "enqueue_ms.infer"])
def test_nothing_to_read(metric, monkeypatch):
    read = harness.reader(metric).read
    ring = _serving_ring()
    _use(monkeypatch, ring)
    # a rehearsal on the CPU
    assert read(_ctx("request", 4, metric, peaks=None)) is None
    # a window longer than the ring's untraced requests
    assert read(_ctx("request", 7, metric)) is None
    # a ring that let go of spans after the window opened
    ring.spans = ring.spans[-14:]
    _use(monkeypatch, ring, dropped=10)
    assert read(_ctx("request", 4, metric)) is None
    # let go before it: the whole window is there
    ring = _serving_ring()
    ring.spans = ring.spans[4:]
    _use(monkeypatch, ring, dropped=4)
    assert read(_ctx("request", 4, metric)) is not None


def test_a_program_without_spans_gives_nothing(monkeypatch):
    """The parent of the port's spans: the module cannot be imported, though
    a ring with the whole window would be read."""
    import sys

    import deepipr_tpu_torch.utils

    cases = ((_training_ring(), "enqueue_ms.train", "step", 5),
             (_serving_ring(), "stage_ms.infer", "request", 4))
    for ring, metric, unit, n in cases:
        _use(monkeypatch, ring)
        assert harness.reader(metric).read(_ctx(unit, n, metric)) is not None
    monkeypatch.setitem(sys.modules, "deepipr_tpu_torch.utils.spans", None)
    monkeypatch.delattr(deepipr_tpu_torch.utils, "spans")
    for ring, metric, unit, n in cases:
        _use(monkeypatch, ring)
        assert harness.reader(metric).read(_ctx(unit, n, metric)) is None


class _Tiny(torch.nn.Module):
    """A model that answers as the port's do: the ``logits`` of a call with
    ``ind`` and ``force_passport``."""

    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(()))

    def forward(self, x, ind=0, force_passport=False):
        return SimpleNamespace(logits=self.scale * x.flatten(1))


def test_the_real_ring_is_read():
    """Two requests of the port's Predictor on the CPU, then one under the
    profiler: the window is the two."""
    from torch.profiler import ProfilerActivity, profile

    from deepipr_tpu_torch.serve import Predictor

    spans.reset()
    pred = Predictor(_Tiny(), device="cpu")
    x = np.zeros((2, 1, 1, 3), np.float32)
    for _ in range(2):
        pred.predict(x)
    with profile(activities=[ProfilerActivity.CPU]):
        pred.predict(x)
    ctx = _ctx("request", 2, "stage_ms.infer")
    try:
        assert harness.reader("stage_ms.infer").read(ctx) > 0
        assert "over 2 requests" in ctx.notes[0]
        assert [s.unit for s in spans.records()
                if s.name == "serve.request"] == [0, 1, 2]
    finally:
        spans.reset()
