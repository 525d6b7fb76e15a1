"""Per-rank FLOPs and collective bytes of what eager PyTorch runs.

The port's counterpart of ``repro.launch.hlo_cost``, which re-derives them
from XLA's HLO with loop trip counts. Eager PyTorch has no HLO: every
operation runs once for each time it is called, so counting the calls is
the trip-count-aware count. :class:`OpCounter` is a ``TorchDispatchMode``
that lets each DTensor-level call through to DTensor (``NotImplemented``)
and sees what DTensor then runs: the sharding propagator's calls on fake
tensors of the global shapes, which it skips, and the calls on this rank's
local shards, with the collectives of each redistribution, which it counts
together with the plain-tensor calls of the step (one rank's work):

- FLOPs by ``torch.utils.flop_counter``'s formulas (``flop_registry``, the
  formulas ``FlopCounterMode`` applies; ``fig2_breakdown.step_flops`` uses
  that mode on one card);
- collective bytes by kind, under ``repro.launch.analysis``'s conventions:
  an all-reduce counts twice its tensor (a ring moves about 2 bytes a
  byte), an all-gather its gathered output, a reduce-scatter its
  unscattered input, an all-to-all its tensor;
- the peak of the bytes that the counted calls allocate and that are alive
  at once (``peak_temp_bytes``): each output that is not a view is counted
  from its call until it is freed. This is the port's own estimate of a
  step's temporary memory a rank, on the meta device as on the card; it
  holds what eager PyTorch keeps alive (autograd's saved tensors
  included), where the reference reads XLA's buffer assignment.
"""

import weakref

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# the functional collectives (``_c10d_functional``) that DTensor and
# ``sharding.comm`` run, by the reference's kind names
COLLECTIVES = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}


def _nbytes(t):
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(x):
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


class OpCounter(TorchDispatchMode):
    """Counts one rank's FLOPs and collective bytes while active."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_by_op = defaultdict(int)
        self.collective = defaultdict(int)
        self.collective_count = 0
        self.live_bytes = self.peak_temp_bytes = 0
        self._live = set()          # ids of the tracked tensors still alive

    def _free(self, n, tid):
        self.live_bytes -= n
        self._live.discard(tid)

    def _track(self, out):
        for t in _tensors(out):
            if t._base is not None or id(t) in self._live:
                continue
            n = _nbytes(t)
            self._live.add(id(t))
            self.live_bytes += n
            weakref.finalize(t, self._free, n, id(t))
        self.peak_temp_bytes = max(self.peak_temp_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # DTensor runs it; its local calls come back here
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in _tensors((args, kwargs))):
            return out                # the propagator's global-shape call
        self._track(out)
        packet = func._overloadpacket
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            self.flops_by_op[str(packet).split(".")[-1]] += n
        kind = COLLECTIVES.get(func.__name__.split(".")[0])
        if kind is not None and func.namespace == "_c10d_functional":
            ins, outs = _tensors((args, kwargs)), _tensors(out)
            if kind == "all-reduce":
                n = 2 * sum(_nbytes(t) for t in ins)
            elif kind == "all-gather":
                n = sum(_nbytes(t) for t in outs)
            else:                   # reduce-scatter: the input; all-to-all: the tensor
                n = sum(_nbytes(t) for t in ins)
            self.collective[kind] += n
            self.collective_count += 1
        return out

    @property
    def collective_bytes(self):
        return sum(self.collective.values())

    def report(self):
        return {"flops": self.flops, "collective_bytes": self.collective_bytes,
                "collective_count": self.collective_count,
                "collectives": dict(self.collective),
                "peak_temp_bytes": self.peak_temp_bytes,
                "flops_by_op": dict(self.flops_by_op)}
