"""``deepipr_tpu_torch/data/prefetch.py`` on the CPU.

The producer thread keeps order and count, stays at most ``size`` batches
ahead, overlaps the consumer (shown with ``threading.Event``s, not a wall
clock), raises a producer's exception in the consumer, and yields the
unprefetched batches bit for bit; the experiment's host-fed epoch trains
to the same weights through it as without it. The card's side (pinned
buffers, the side stream) is held in tests/test_torch_port_cuda.py.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from deepipr_tpu_torch.data.datasets import DataLoader, synthetic_dataset
from deepipr_tpu_torch.data.prefetch import prefetch

WAIT_S = 30  # a bound on a hang only; no assertion rests on time


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread per test, as the other port test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _loader(raw=False, **kw):
    x, y, _, _ = synthetic_dataset(num_train=40, num_test=0, size=8, seed=1)
    return DataLoader(x, y, 8, shuffle=True, train_augment=not raw,
                      drop_last=True, seed=3, raw=raw, **kw)


@pytest.mark.parametrize("raw", [False, True], ids=["augmented", "raw"])
@pytest.mark.parametrize("size", [1, 2, 5])
def test_prefetched_batches_equal_the_loaders_bit_for_bit(raw, size):
    want = list(_loader(raw))
    got = list(prefetch(_loader(raw), size=size, device="cpu"))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            assert g[k].numpy().dtype == w[k].dtype
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_arrays_and_other_items_pass_through_in_order():
    items = [np.arange(i, i + 3) for i in range(7)]
    got = list(prefetch(iter(items), size=2, device="cpu"))
    assert [t.tolist() for t in got] == [a.tolist() for a in items]
    batch = {"image": np.ones((2, 2)), "epoch": 3, "name": "x"}
    (out,) = prefetch([batch], device="cpu")
    assert out["epoch"] == 3 and out["name"] == "x"
    # a flipped view is made contiguous, not refused
    (flipped,) = prefetch([np.arange(4)[::-1]], device="cpu")
    assert flipped.tolist() == [3, 2, 1, 0]


def test_an_empty_source_yields_nothing():
    assert list(prefetch(iter(()), device="cpu")) == []


def test_a_producer_exception_is_raised_in_the_consumer():
    def source():
        yield {"x": np.zeros(2)}
        yield {"x": np.ones(2)}
        raise KeyError("broken batch 3")

    got = []
    with pytest.raises(KeyError, match="broken batch 3"):
        for batch in prefetch(source(), size=2, device="cpu"):
            got.append(batch["x"].tolist())
    assert got == [[0.0, 0.0], [1.0, 1.0]]


def test_the_producer_works_while_the_consumer_holds_a_batch():
    """The consumer holds batch 0 and waits until the source has made
    batch 1, which only a producer running alongside can do."""
    made = [threading.Event() for _ in range(3)]

    def source():
        for i in range(3):
            made[i].set()
            yield np.full(2, i)

    it = prefetch(source(), size=2, device="cpu")
    first = next(it)
    assert made[1].wait(WAIT_S), "the producer did not run ahead"
    assert first.tolist() == [0, 0]
    assert [t.tolist() for t in it] == [[1, 1], [2, 2]]


@pytest.mark.parametrize("size", [1, 3])
def test_the_producer_stays_within_size_batches_ahead(size):
    """When the source makes batch n the consumer has taken at least
    n - size - 1: ``size`` wait in the queue and one in the producer's
    hand. The consumer waits on the source between its reads."""
    taken, ahead = [0], []
    asked = [threading.Event() for _ in range(12)]

    def source():
        for n in range(12):
            ahead.append(n - taken[0])
            asked[n].set()
            yield np.array([n])

    it = prefetch(source(), size=size, device="cpu")
    for n in range(12):
        got = next(it)
        taken[0] += 1
        assert got.tolist() == [n]
        # let the producer fill what it may before the next read
        asked[min(n + size, 11)].wait(WAIT_S)
    assert max(ahead) <= size + 1


def test_leaving_early_stops_the_producer():
    made = []
    stopped = threading.Event()

    def source():
        try:
            for i in range(1000):
                made.append(i)
                yield np.array([i])
        finally:
            stopped.set()

    it = prefetch(source(), size=2, device="cpu")
    assert next(it).tolist() == [0]
    it.close()
    # the producer finds the consumer gone at its next put and returns,
    # and its source is closed when the producer lets go of it
    assert stopped.wait(WAIT_S), "the producer did not stop"
    assert len(made) <= 1 + 2 + 1


def test_stats_count_each_batch():
    stats = {}
    n = len(list(prefetch(_loader(), device="cpu", stats=stats)))
    assert n == 5 and len(stats["host_s"]) == len(stats["stage_s"]) == 5
    assert all(s >= 0 for s in stats["host_s"] + stats["stage_s"])


def test_size_must_be_positive():
    with pytest.raises(ValueError, match="size"):
        list(prefetch([], size=0, device="cpu"))


def test_the_card_is_asked_for_unless_the_cpu_is(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(prefetch([np.zeros(1)]))


@pytest.mark.parametrize("backdoor", [False, True], ids=["v2", "v3"])
def test_the_host_fed_epoch_trains_alike_with_and_without_prefetch(
        tmp_path, monkeypatch, backdoor):
    """The experiment's host-fed epoch through prefetch and through the
    plain batch stream from the same start: equal weights, bit for bit."""
    from test_torch_port_data import write_trigger_tree
    from test_torch_port_experiment import base_args

    from deepipr_tpu_torch.train import experiment

    over = {"train_private": True, "key_type": "random"}
    if backdoor:
        write_trigger_tree(str(tmp_path / "trigger_set"), n=6, nested=False)
        over.update(train_backdoor=True,
                    trigger_path=str(tmp_path / "trigger_set" / "pics"))
    states = []
    for wrapped in (True, False):
        if not wrapped:
            monkeypatch.setattr(experiment, "prefetch",
                                lambda it, **kw: iter(it))
        exp = experiment.ClassificationExperiment(
            base_args(tmp_path / str(wrapped), **over), "cpu")
        metrics = exp._train_epoch(1)
        assert np.isfinite(metrics["loss"])
        assert bool(exp.prefetch_stats) == wrapped
        states.append(exp.model.state_dict())
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k

