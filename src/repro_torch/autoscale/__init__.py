"""Elastic control plane: the closed loop that RESIZES.

A copy of ``repro.autoscale`` (pure Python), kept so that the port
imports nothing of the JAX package.

The telemetry package holds the senses (registry, bottleneck
attribution) and the live scrape plane, `fault` the survival plane; this
package is the half that acts: a hysteresis
policy (`policy.py`) mapping the live `BottleneckReport` class + SLO
burn state to a resize recommendation, and a controller thread
(`controller.py`) that drives the seams that already exist —
`ActorHostPool.request_grow`/`request_drain` and
`InferenceServer.set_active_replicas` — while logging every decision
with its evidence at the ``/autoscaler`` ops endpoint.

Opt-in via ``SeedSystem(autoscale=AutoscaleConfig(...))``; fully inert
by default.
"""

from .policy import Action, AutoscaleConfig, AutoscalePolicy, PolicyInputs
from .controller import AutoscaleController, DecisionLog

__all__ = [
    "Action", "AutoscaleConfig", "AutoscalePolicy", "PolicyInputs",
    "AutoscaleController", "DecisionLog",
]
