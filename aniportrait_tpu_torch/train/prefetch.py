"""The port's copy of ``aniportrait_tpu/train/prefetch.py`` (JAX-free; held
to the original by ``tests/test_torch_copies.py``).

Host-side input prefetching.

The reference overlaps data loading with the GPU step via 4 DataLoader
worker processes (train_stage_1.py:400-407).  Here the equivalent is a
background thread running the (cv2-heavy, GIL-releasing) batch generator a
fixed depth ahead, so decode + pose rasterisation never sit on the step's
critical path.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_DONE = object()


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    """Iterate ``iterable`` on a daemon thread, ``depth`` items ahead.

    Exceptions in the producer re-raise at the consumer's next pull."""
    q: queue.Queue = queue.Queue(maxsize=depth)

    def producer():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # re-raise on the consumer side
            q.put(e)
            return
        q.put(_DONE)

    t = threading.Thread(target=producer, daemon=True, name="batch-prefetch")
    t.start()
    while True:
        item = q.get()
        if item is _DONE:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
