"""Background-thread iterator prefetch.

The reference's hot loop does host-side batch assembly inline
(``train.py:302-335``: PyG collate + ``to_dense_adj`` + one-hot on every
iteration).  Our batches are plain array slices, but on a remote-attached
TPU even small host work serializes with dispatch latency; this utility
overlaps it with device execution — a producer thread runs the upstream
iterator and parks finished items in a bounded queue.

Exceptions raised by the producer are re-raised in the consumer, and the
producer is a daemon thread so an abandoned prefetcher never blocks
interpreter exit.

Copied from ``druggen_tpu/utils/prefetch.py``; imports point at this package.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


class ThreadPrefetcher:
    """Iterate ``src`` on a background thread, ``depth`` items ahead."""

    def __init__(self, src: Iterable, depth: int = 2):
        if depth <= 0:
            raise ValueError("depth must be positive")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._stop = threading.Event()

        def _produce():
            try:
                for item in src:
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:  # re-raised on the consumer side
                self._err = e
            finally:
                try:
                    self._q.put(_SENTINEL, timeout=10)
                except queue.Full:
                    pass

        self._thread = threading.Thread(target=_produce, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the producer (for early exit from the consuming loop)."""
        self._stop.set()


def prefetch(src: Iterable, depth: int = 2) -> Iterable:
    """``depth <= 0`` returns ``src`` unchanged (prefetch disabled)."""
    if depth <= 0:
        return src
    return ThreadPrefetcher(src, depth)
