"""Host-side data pipeline: background prefetch and batch sharding.

Mirrors ``repro.data.pipeline``. The learner must never wait on batch
assembly: ``prefetch`` runs the producer in a thread with a bounded
queue; ``shard_batch`` lays a batch out on a mesh, dim 0 over the
'act_batch' mesh axes, as DTensors whose shards each rank cuts from the
batch it holds (no collective).
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


def shard_batch(batch, mesh, rules, seq_axis=None):
    """Shard a batch dict: dim 0 = batch -> the 'act_batch' mesh axes (and
    dim 1 -> `seq_axis`'s, when given), by ``logical_to_spec`` as the
    reference's. Every rank passes the whole batch."""
    import torch

    from repro_torch.sharding.param import shard_tensor
    from repro_torch.sharding.rules import logical_to_spec, placements

    def put(x):
        x = torch.as_tensor(x)
        axes = ["act_batch"] + [None] * (x.dim() - 1)
        if seq_axis is not None and x.dim() > 1:
            axes[1] = seq_axis
        return shard_tensor(x, mesh, placements(logical_to_spec(axes, rules), mesh))
    return {k: put(v) for k, v in batch.items()}


def batch_iterator(gen_fn: Callable, n: int = None):
    i = 0
    while n is None or i < n:
        yield gen_fn(i)
        i += 1
