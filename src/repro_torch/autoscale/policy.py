"""Resize policy: bottleneck class + SLO burn state -> one damped action.

A copy of ``repro.autoscale.policy`` (pure Python), kept so that the port
imports nothing of the JAX package.

The paper's finding is that the actor plane (CPU) is the usual limiter
and the CPU/GPU ratio the balancing metric; `attribute_bottleneck`
already classifies live windows {actor,inference,learner,wire}-bound.
The mapping here is the obvious one — and deliberately conservative
everywhere it is not obvious:

- **actor-bound**  -> grow actor hosts (more CPU rollout capacity);
- **inference-bound** -> activate another server replica (more GPU-side
  batch capacity, up to the constructed maximum);
- **learner-bound** -> the queue is overfull and dropping; adding
  producers makes it WORSE. Shrink one host only when the drop-rate SLO
  is actually burning, else hold and report;
- **wire-bound / idle / unknown** -> hold and report. No actuator we own
  fixes the wire; resizing on noise is strictly worse than waiting.

Three dampers keep the loop from flapping, in priority order:

1. **Churn suppression** — the `/varz` ``stats.recovery`` counters
   (``host_restarts``, ``reconnects``, ``gateway_failovers``) moving
   within ``churn_window_s`` mean the survival plane is mid-recovery:
   throughput dips and bottleneck flips during respawn/failover are
   symptoms, not capacity signals. Any recent churn SUPPRESSES scaling
   (the hard requirement: damp against churn, never scale on it).
2. **Hysteresis** — a candidate action must be re-proposed for
   ``grow_after_ticks`` (or ``shrink_after_ticks``, deliberately larger:
   shrinking destroys capacity) CONSECUTIVE ticks before it fires; any
   tick proposing a different candidate resets the streak.
3. **Cooldown** — after an action fires, every signal is ignored for
   ``cooldown_s`` so the new topology's measurements (spawn cost, first
   unroll flush) settle before they can justify the next move.

Bounds are hard: a grow at ``max_hosts``/active==constructed replicas or
a shrink at the minimum becomes a hold with ``saturated=True`` — the
e2e convergence gate ("class flips away from actor-bound OR the host cap
binds") reads exactly that flag.

The policy is pure state-machine: no threads, no clocks of its own
(callers pass ``now``), no knowledge of pools or servers — which is what
makes it unit-testable tick by tick.
"""

from dataclasses import dataclass, field
from typing import Dict, Optional

from ..telemetry.slo import SLOSet, SLOVerdict

__all__ = ["AutoscaleConfig", "PolicyInputs", "Action", "AutoscalePolicy"]

# Recovery counters that indicate in-flight churn (must suppress scaling).
CHURN_COUNTERS = ("host_restarts", "reconnects", "gateway_failovers")

_GROW_KINDS = ("grow_hosts", "grow_replicas")
_SHRINK_KINDS = ("shrink_hosts", "shrink_replicas")
_KINDS = ("hold",) + _GROW_KINDS + _SHRINK_KINDS


@dataclass
class AutoscaleConfig:
    """The single opt-in knob: ``SeedSystem(autoscale=AutoscaleConfig())``.

    Defaults are sized for the smoke/e2e scale (seconds, not minutes);
    production deployments would stretch every window by ~an order of
    magnitude. ``max_replicas=None`` means "whatever the server was
    constructed with" — the controller can only activate capacity that
    already exists, never build it.
    """

    interval_s: float = 0.5          # sense/decide tick period
    min_hosts: int = 1
    max_hosts: int = 4
    min_replicas: int = 1
    max_replicas: Optional[int] = None
    grow_after_ticks: int = 2
    shrink_after_ticks: int = 4
    cooldown_s: float = 3.0
    churn_window_s: float = 5.0
    capacity: int = 1024             # time-series ring length (points)
    log_capacity: int = 256          # decision-log ring length (entries)
    slos: Optional[SLOSet] = None    # None -> SeedSystem installs defaults
    dry_run: bool = False            # sense+decide+log, never act

    def __post_init__(self):
        if self.interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {self.interval_s}")
        if not 1 <= self.min_hosts <= self.max_hosts:
            raise ValueError(
                f"need 1 <= min_hosts <= max_hosts, got "
                f"{self.min_hosts}/{self.max_hosts}")
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas is not None and \
                self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas {self.max_replicas} < min_replicas "
                f"{self.min_replicas}")
        if self.grow_after_ticks < 1 or self.shrink_after_ticks < 1:
            raise ValueError("hysteresis tick counts must be >= 1")
        if self.cooldown_s < 0 or self.churn_window_s < 0:
            raise ValueError("cooldown_s/churn_window_s must be >= 0")


@dataclass
class PolicyInputs:
    """Everything one decide tick looks at — assembled by the controller,
    plain data so tests can fabricate arbitrary worlds."""

    now: float
    bottleneck: str                          # BottleneckReport.bottleneck
    verdicts: Dict[str, SLOVerdict] = field(default_factory=dict)
    churn_rate: float = 0.0                  # summed counter movement /s
    hosts: int = 1                           # live (non-draining) hosts
    replicas_active: int = 1
    replicas_max: int = 1                    # constructed replica count


@dataclass
class Action:
    kind: str                                # one of _KINDS
    reason: str
    candidate: str = "hold"                  # pre-damping proposal
    saturated: bool = False                  # proposal blocked by a bound
    streak: int = 0                          # hysteresis progress

    def as_dict(self) -> dict:
        return {"kind": self.kind, "reason": self.reason,
                "candidate": self.candidate, "saturated": self.saturated,
                "streak": self.streak}


class AutoscalePolicy:
    """Tick-driven state machine; call `decide(inputs)` once per tick."""

    def __init__(self, config: AutoscaleConfig):
        self.config = config
        self._streak_kind = "hold"
        self._streak = 0
        self._last_action_t: Optional[float] = None

    # ------------------------------------------------------------ helpers

    def _candidate(self, inp: PolicyInputs) -> tuple:
        """Raw (kind, reason) from bottleneck class + SLO state, before
        any damping or bound checks."""
        drop_burning = any(
            v.burning and v.name.startswith("drop")
            for v in inp.verdicts.values())
        b = inp.bottleneck
        if b == "actor-bound":
            return "grow_hosts", "actor-bound window"
        if b == "inference-bound":
            return "grow_replicas", "inference-bound window"
        if b == "learner-bound":
            if drop_burning:
                return ("shrink_hosts",
                        "learner-bound and drop-rate SLO burning: "
                        "shed producer load")
            return "hold", "learner-bound: adding producers would worsen drops"
        if b == "wire-bound":
            return "hold", "wire-bound: no actuator for the wire"
        return "hold", f"bottleneck class {b!r}: nothing to resize"

    def _bounded(self, kind: str, inp: PolicyInputs) -> tuple:
        """(kind, saturated) after clamping to topology bounds."""
        cfg = self.config
        rep_max = min(inp.replicas_max,
                      cfg.max_replicas if cfg.max_replicas else
                      inp.replicas_max)
        if kind == "grow_hosts" and inp.hosts >= cfg.max_hosts:
            return "hold", True
        if kind == "shrink_hosts" and inp.hosts <= cfg.min_hosts:
            return "hold", True
        if kind == "grow_replicas" and inp.replicas_active >= rep_max:
            return "hold", True
        if kind == "shrink_replicas" and \
                inp.replicas_active <= cfg.min_replicas:
            return "hold", True
        return kind, False

    # ------------------------------------------------------------- decide

    def decide(self, inp: PolicyInputs) -> Action:
        cfg = self.config
        candidate, why = self._candidate(inp)

        # Damper 1: churn suppression beats every capacity signal.
        if candidate != "hold" and inp.churn_rate > 0.0:
            self._streak_kind, self._streak = "hold", 0
            return Action(
                kind="hold", candidate=candidate, streak=0,
                reason=(f"suppressed: recovery churn "
                        f"({inp.churn_rate:.3g}/s) within "
                        f"{cfg.churn_window_s:.3g}s window — {why}"))

        # Damper 2: cooldown after any fired action.
        if candidate != "hold" and self._last_action_t is not None and \
                inp.now - self._last_action_t < cfg.cooldown_s:
            left = cfg.cooldown_s - (inp.now - self._last_action_t)
            return Action(
                kind="hold", candidate=candidate, streak=self._streak,
                reason=f"cooldown ({left:.2g}s left) — {why}")

        # Bounds: a saturated proposal is a hold that SAYS it's capped.
        bounded, saturated = self._bounded(candidate, inp)
        if saturated:
            self._streak_kind, self._streak = "hold", 0
            return Action(
                kind="hold", candidate=candidate, saturated=True, streak=0,
                reason=f"at bound for {candidate} — {why}")

        # Damper 3: hysteresis — consecutive identical proposals only.
        if bounded == self._streak_kind:
            self._streak += 1
        else:
            self._streak_kind, self._streak = bounded, 1
        if bounded == "hold":
            self._streak = 0
            return Action(kind="hold", candidate="hold", reason=why)
        need = (cfg.grow_after_ticks if bounded in _GROW_KINDS
                else cfg.shrink_after_ticks)
        if self._streak < need:
            return Action(
                kind="hold", candidate=bounded, streak=self._streak,
                reason=f"hysteresis {self._streak}/{need} ticks — {why}")

        self._streak_kind, self._streak = "hold", 0
        self._last_action_t = inp.now
        return Action(kind=bounded, candidate=bounded, streak=need,
                      reason=why)

    def note_external_action(self, now: float):
        """Start a cooldown for an action the policy did not fire (e.g. a
        dry-run operator resize) so the next ticks stay quiet."""
        self._last_action_t = now
