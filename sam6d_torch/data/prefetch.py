"""Host-side input prefetching: the port's copy of `iter_prefetched` from
`sam6d_tpu/data/prefetch.py`. A bounded queue fed by one thread: frame
decoding is numpy/PIL work that releases the GIL, so the next frame is read
while the consumer drives the device (the `stream` entry point). The
training loader (`PrefetchLoader`) waits for the training port.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


def iter_prefetched(items: Iterable, depth: int = 2) -> Iterator:
    """Yield from `items` with a background thread staying `depth` ahead —
    frame IO/decode overlaps device compute."""
    q: queue.Queue = queue.Queue(maxsize=depth)

    def producer():
        try:
            for it in items:
                q.put(it)
        except Exception as e:
            q.put(e)
            return
        q.put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            break
        if isinstance(item, Exception):
            raise item
        yield item
    t.join(timeout=2.0)
