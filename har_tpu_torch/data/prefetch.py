"""Host→device prefetching for streamed training data.

Port of ``har_tpu/data/prefetch.py``.  The staged trainer keeps the whole
dataset on the device; the streamed one (``Trainer(scan=False)``) feeds
each step's batch from host memory instead, and this keeps the next
``size`` transfers in flight while the current step computes.

On a CUDA device the default transfer (:class:`PinnedRing`) stages each
item in one of a ring of ``size`` pinned host buffers and copies it with
``non_blocking`` on a side stream:

- an item is a tensor (or a tuple of them), or, given ``source`` host
  tensors, a vector of row indices: ``torch.index_select(src, 0, idx,
  out=buf)`` then gathers the rows straight into the pinned buffer, with
  no second host copy;
- each buffer has an event recorded after its copy; the host waits on it
  before it refills that buffer;
- before an item is handed over, the consumer's stream waits on the side
  stream (``wait_stream``) and every device tensor of the item is marked
  with ``record_stream``, so the caching allocator does not reuse its
  memory while the consumer's work on it is queued.

On the CPU the default transfer is a plain copy (``pin_memory`` needs
CUDA).
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator, TypeVar

import numpy as np
import torch

from har_tpu_torch.device import resolve_device

T = TypeVar("T")


def _as_tuple(item):
    return item if isinstance(item, tuple) else (item,)


class PinnedRing:
    """The CUDA transfer: ``size`` pinned staging slots, one side stream.

    ``source`` (a tuple of host tensors, first dimension rows) makes an
    item a vector of row indices; without it an item is a tensor or numpy
    array, or a tuple of them.  Returns a tensor or a tuple as it was
    given.
    """

    def __init__(self, size: int, device: torch.device, source=None):
        self.device = device
        self.source = None if source is None else _as_tuple(source)
        self.stream = torch.cuda.Stream(device)
        self.slots: list[dict] = [
            {"buffers": None, "event": None} for _ in range(size)
        ]
        self.count = 0

    def _buffers(self, slot: dict, shapes) -> list:
        want = [(tuple(shape), dtype) for shape, dtype in shapes]
        have = slot["buffers"]
        if have is None or [(tuple(b.shape), b.dtype) for b in have] != want:
            slot["buffers"] = [
                torch.empty(shape, dtype=dtype, pin_memory=True)
                for shape, dtype in want
            ]
        return slot["buffers"]

    def __call__(self, item):
        slot = self.slots[self.count % len(self.slots)]
        self.count += 1
        if slot["event"] is not None:
            slot["event"].synchronize()  # its last copy out has finished
        if self.source is not None:
            idx = torch.as_tensor(np.asarray(item), dtype=torch.int64)
            bufs = self._buffers(
                slot, [((len(idx), *s.shape[1:]), s.dtype) for s in self.source]
            )
            for src, buf in zip(self.source, bufs):
                torch.index_select(src, 0, idx, out=buf)
            single = len(bufs) == 1
        else:
            parts = [torch.as_tensor(p) for p in _as_tuple(item)]
            bufs = self._buffers(slot, [(p.shape, p.dtype) for p in parts])
            for part, buf in zip(parts, bufs):
                buf.copy_(part)
            single = not isinstance(item, tuple)
        with torch.cuda.stream(self.stream):
            out = [buf.to(self.device, non_blocking=True) for buf in bufs]
            slot["event"] = torch.cuda.Event()
            slot["event"].record(self.stream)
        return out[0] if single else tuple(out)

    def handover(self, item):
        """``item`` made safe to use on the consumer's current stream."""
        current = torch.cuda.current_stream(self.device)
        current.wait_stream(self.stream)
        for t in _as_tuple(item):
            t.record_stream(current)
        return item


def _cpu_copy(source):
    """The CPU transfer: a plain copy of the item (or of its rows)."""
    if source is not None:
        source = _as_tuple(source)

        def gather(idx):
            idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64)
            out = tuple(torch.index_select(src, 0, idx) for src in source)
            return out[0] if len(out) == 1 else out

        return gather

    def copy(item):
        parts = tuple(torch.as_tensor(p).clone() for p in _as_tuple(item))
        return parts if isinstance(item, tuple) else parts[0]

    return copy


def prefetch_to_device(
    iterator: Iterable[T],
    size: int = 2,
    transfer: Callable[[T], T] | None = None,
    device: str | torch.device = "cuda",
    source=None,
) -> Iterator[T]:
    """Yield items already on ``device``, keeping ``size`` transfers in
    flight.

    ``transfer`` maps a host item to device tensors (default: the pinned
    ring on CUDA, a plain copy on the CPU; see the module docstring).
    ``source`` makes the items row indices into those host tensors.
    ``size=2`` (double buffering) hides the transfer behind the step.
    """
    if size < 1:
        raise ValueError("prefetch size must be >= 1")
    handover = None
    if transfer is None:
        device = resolve_device(device)
        if device.type == "cuda":
            ring = PinnedRing(size, device, source)
            transfer, handover = ring, ring.handover
        else:
            transfer = _cpu_copy(source)
    queue: collections.deque = collections.deque()
    it = iter(iterator)
    try:
        while True:
            while len(queue) < size:
                queue.append(transfer(next(it)))
            item = queue.popleft()
            yield handover(item) if handover else item
    except StopIteration:
        while queue:
            item = queue.popleft()
            yield handover(item) if handover else item
