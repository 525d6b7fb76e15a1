"""Host-side data pipeline: background prefetch.

Mirrors ``repro.data.pipeline`` (``shard_batch`` waits for sharding). The
learner must never wait on batch assembly: ``prefetch`` runs the producer
in a thread with a bounded queue.
"""

import queue
import threading
from typing import Callable, Iterator


def prefetch(it: Iterator, size: int = 2) -> Iterator:
    q: "queue.Queue" = queue.Queue(maxsize=size)
    _done = object()

    def producer():
        try:
            for x in it:
                q.put(x)
        finally:
            q.put(_done)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        x = q.get()
        if x is _done:
            return
        yield x


def batch_iterator(gen_fn: Callable, n: int = None):
    i = 0
    while n is None or i < n:
        yield gen_fn(i)
        i += 1
