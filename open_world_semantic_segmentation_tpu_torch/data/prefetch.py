"""Background prefetch: host items, or batches already on the device.

A thread produces upcoming items (decode and resample) while the device
works on the current one.

- ``iter_prefetch``: host items only; device copies stay with the consumer.
- ``prefetch_to_device``: dicts of numpy arrays, each array copied to the
  device with ``size`` batches in flight. On CUDA the producer thread
  copies each batch into pinned host memory and the consumer issues
  ``non_blocking`` copies on the current stream, so the transfer overlaps
  the step before it.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterable, Iterator

import torch

_END = object()


def _worker(it, q, stop):
    try:
        for item in it:
            if stop.is_set():
                return
            q.put(item)
        q.put(_END)
    except BaseException as e:  # surface loader errors to the consumer
        q.put(e)


def iter_prefetch(iterable: Iterable, depth: int = 4) -> Iterator:
    """Iterate ``iterable`` with up to ``depth`` items produced ahead by a
    background thread; an exception in the producer is raised here."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    t = threading.Thread(target=_worker, args=(iter(iterable), q, stop),
                         daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # free a slot, so a producer blocked on a full queue gets to see
        # ``stop`` and end its thread
        try:
            q.get_nowait()
        except queue.Empty:
            pass


def prefetch_to_device(iterable: Iterable, device, *,
                       size: int = 2) -> Iterator:
    """Iterate ``iterable`` (dicts of numpy arrays) as dicts of tensors on
    ``device``, with ``size`` batches in flight on it; an exception in the
    producer is raised here."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def host(batch):
        out = {k: torch.from_numpy(v) for k, v in batch.items()}
        return {k: t.pin_memory() for k, t in out.items()} if pin else out

    pending = collections.deque()
    for batch in iter_prefetch(map(host, iterable), depth=size):
        pending.append({k: t.to(device, non_blocking=pin)
                        for k, t in batch.items()})
        if len(pending) == size:
            yield pending.popleft()
    yield from pending
