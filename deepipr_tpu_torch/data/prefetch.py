"""Host-to-device pipelining: a producer thread keeps batches ready.

Counterpart of ``deepipr_tpu/data/prefetch.py``. The train step's kernels
run asynchronously, but the host work of the NEXT batch (decode, crop,
stack, normalize) would otherwise start only after each step is queued,
and its copy to the card would wait on the step's stream. A producer
thread keeps a bounded queue ``size`` batches ahead, and a producer's
exception is raised again in the consumer.

On a CUDA device each batch's arrays are staged through pinned host
buffers and copied to the card with ``non_blocking`` copies on a side
stream, so the copy overlaps the step:

- the pinned buffers form a ring of ``size + 2`` slots, one per batch that
  can be alive at once (queued, being made, being consumed); a slot is
  written again only after the event recorded behind its last copy has
  completed, since ``cudaHostAlloc`` per batch would be slow;
- the consumer's stream waits on each batch's event before its first use,
  and each device tensor is ``record_stream``'d on the consumer's stream,
  so the caching allocator does not hand the block made on the side
  stream to a later batch while the step still reads it.

On the CPU the arrays are only converted to tensors. Either way the
batches equal the unprefetched ones bit for bit.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from deepipr_tpu_torch.utils.device import DeviceLike, resolve_device
from deepipr_tpu_torch.utils.spans import span

_END = object()
_POLL_S = 0.05  # how often a blocked producer looks for an abandoned consumer


class _PinnedSlot:
    """Pinned host buffers for one batch in flight, by key, grown on
    demand, and the event behind their last copy to the card."""

    def __init__(self):
        self.buffers: Dict[str, torch.Tensor] = {}
        self.event = None

    def stage(self, key: str, array: np.ndarray) -> torch.Tensor:
        """``array`` copied into this slot's pinned buffer for ``key``, as a
        tensor of its shape and dtype."""
        src = torch.from_numpy(np.ascontiguousarray(array))
        nbytes = src.numel() * src.element_size()
        buf = self.buffers.get(key)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              pin_memory=True)
            self.buffers[key] = buf
        view = buf[:nbytes].view(src.dtype).view(src.shape)
        view.copy_(src)
        return view


def _to_cpu(item):
    if isinstance(item, dict):
        return {k: _to_cpu(v) for k, v in item.items()}
    if isinstance(item, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(item))
    return item


def prefetch(iterable: Iterable, size: int = 2,
             device: DeviceLike = "cuda",
             stats: Optional[Dict[str, List[float]]] = None) -> Iterator:
    """Iterate ``iterable`` (of dicts of NumPy arrays, or arrays) on a
    producer thread, ``size`` batches ahead, each array as a tensor on
    ``device``. Leaving the loop early stops the producer.

    Each batch's seconds in ``iterable`` (the host's work: decode, crop,
    stack) are a ``data.produce`` span, its seconds staging and queueing the
    copy a ``data.stage`` span (utils/spans.py). ``stats``: where given, the
    producer also appends those two durations to ``stats["host_s"]`` and
    ``stats["stage_s"]``."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    if dev.type == "cuda":
        side = torch.cuda.Stream(dev)
        ring: List[_PinnedSlot] = [_PinnedSlot() for _ in range(size + 2)]

        def convert(item, slot: int):
            entry = ring[slot]
            if entry.event is not None:
                entry.event.synchronize()  # its last copy has left the buffer
            with torch.cuda.stream(side):
                def move(key, value):
                    if not isinstance(value, np.ndarray):
                        return value
                    return entry.stage(key, value).to(dev, non_blocking=True)

                out = ({k: move(k, v) for k, v in item.items()}
                       if isinstance(item, dict) else move("", item))
                entry.event = torch.cuda.Event()
                entry.event.record(side)
            return out, entry.event
    else:
        def convert(item, slot: int):
            return _to_cpu(item), None

    if stats is not None:
        stats.setdefault("host_s", [])
        stats.setdefault("stage_s", [])

    def producer():
        try:
            if dev.type == "cuda":
                torch.cuda.set_device(dev)  # this thread's current device
            it, n = iter(iterable), 0
            while True:
                with span("data.produce") as made:
                    item = next(it, _END)
                if item is _END:
                    break
                with span("data.stage") as staged:
                    moved = convert(item, n % (size + 2))
                if stats is not None:
                    stats["host_s"].append(made.seconds)
                    stats["stage_s"].append(staged.seconds)
                if not put(moved):
                    return
                n += 1
            put(_END)
        except BaseException as e:  # raised again on the consumer's side
            put(e)

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            batch, event = item
            if event is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(event)
                for t in (batch.values() if isinstance(batch, dict)
                          else (batch,)):
                    if isinstance(t, torch.Tensor):
                        t.record_stream(stream)
            yield batch
    finally:
        stop.set()
