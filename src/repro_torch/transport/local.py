"""In-process transport: the seam object for today's single-host layout.

A copy of ``repro.transport.local`` (numpy only).

`Transport` is the contract `core.actor.Actor` programs against — it is
exactly the `InferenceServer` surface the actor already used (that is the
point: the server's queue API *was* the transport all along, as its module
docstring promised). `InProcTransport` forwards every call to a wrapped
`InferenceServer`, byte-for-byte identical behavior to handing the actor
the server itself, so `SeedSystem(transport="inproc")` — the default —
cannot regress the host backend. `repro_torch.transport.socket` implements the
same contract over TCP.
"""

from typing import Optional

import numpy as np


class Transport:
    """What an Actor needs from its inference endpoint.

    ``submit_batch(actor_id, obs[E, ...])`` returns a queue-like whose
    ``get()`` yields either the ``(E,)`` action array or a
    `repro_torch.core.inference.ReplyError` (fail-fast poison). ``error`` is a
    traceback/message once the endpoint has died — actors poll it instead
    of blocking forever on a reply that will never come.
    """

    error: Optional[str] = None

    def submit(self, actor_id: int, obs: np.ndarray):
        raise NotImplementedError

    def submit_batch(self, actor_id: int, obs: np.ndarray,
                     trace_seq: int = 0):
        """``trace_seq`` (optional, telemetry): a `repro_torch.telemetry`
        stitch id the endpoint threads through to every span this
        request touches (and onto the wire, for remote endpoints)."""
        raise NotImplementedError

    def close(self):
        """Release connections/threads. Idempotent."""


class InProcTransport(Transport):
    """The identity transport: delegate to a local `InferenceServer`.

    Exists so the two deployment shapes differ only in which Transport the
    actor holds — no behavior change for the in-process default.
    """

    def __init__(self, server):
        self.server = server

    @property
    def error(self):
        return self.server.error

    def submit(self, actor_id: int, obs: np.ndarray):
        return self.server.submit(actor_id, obs)

    def submit_batch(self, actor_id: int, obs: np.ndarray,
                     trace_seq: int = 0):
        return self.server.submit_batch(actor_id, obs, trace_seq=trace_seq)
