"""Host-side background prefetch.

A thread produces upcoming items (PIL decode and resample) while the device
works on the current one. Device copies stay with the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

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
