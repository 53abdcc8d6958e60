"""Host-side input prefetching: the port's copy of
`sam6d_tpu/data/prefetch.py`. Bounded queues fed by threads: batch assembly
and frame decoding are numpy/PIL work that releases the GIL, so the next
input is built while the consumer drives the device.

- `PrefetchLoader`: N workers each build full batches with their own
  RandomState (seed + i) into a bounded queue (the `train` entry point; the
  reference trains with 24 DataLoader workers, config/base.yaml:71).
- `iter_prefetched`: wrap any generator so the next item is produced while
  the consumer computes (the `stream` entry point, the BOP drivers).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np

_SENTINEL = object()


class PrefetchLoader:
    """Multi-worker batch prefetcher.

    `make_batch(rng) -> batch` must be thread-safe with respect to shared
    read-only state (files are opened per call). Worker i owns
    RandomState(seed + i). A worker's exception is raised by the next
    `get`; once every worker has exited and the queue is drained, `get`
    raises instead of blocking.
    """

    def __init__(self, make_batch: Callable, num_workers: int = 4,
                 depth: int = 8, seed: int = 1):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._live = num_workers
        self._live_lock = threading.Lock()
        self._first_exc: Exception | None = None
        self._threads = []
        for i in range(num_workers):
            t = threading.Thread(target=self._worker, args=(seed + i,), daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self, seed: int):
        rng = np.random.RandomState(seed)
        try:
            while not self._stop.is_set():
                try:
                    batch = self._make(rng)
                except Exception as e:  # surface worker crashes to the consumer
                    self._q.put(e)
                    return
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        finally:
            with self._live_lock:
                self._live -= 1

    def get(self):
        while True:
            try:
                item = self._q.get(timeout=0.5)
            except queue.Empty:
                with self._live_lock:
                    dead = self._live == 0
                if dead and self._q.empty():
                    raise RuntimeError("all PrefetchLoader workers have exited"
                                       ) from self._first_exc
                continue
            if isinstance(item, Exception):
                if self._first_exc is None:
                    self._first_exc = item
                raise item
            return item

    def __iter__(self):
        while True:
            yield self.get()

    def close(self):
        self._stop.set()
        # drain so producers blocked on put() can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


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
