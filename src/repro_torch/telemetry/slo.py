"""SLO objectives evaluated as multi-window burn rates over the store.

A copy of ``repro.telemetry.slo`` (pure Python), kept so that the port
imports nothing of the JAX package.

An SLO here is a bound on a live series — ``frames_per_s`` must stay
ABOVE a floor, ``infer_p99_ms`` and ``drop_rate`` must stay BELOW a
ceiling. A single instantaneous breach is noise (one slow GC tick, one
queue hiccup); paging a controller on it causes flapping. The standard
fix (Google SRE workbook, "multiwindow, multi-burn-rate alerts") is to
alert only when the *violation fraction* — the share of sampled points
in breach — exceeds a threshold over BOTH a fast window (is it
happening NOW?) and a slow window (has it been happening long enough to
matter?). The fast window gates reaction latency; the slow window gates
sustained evidence; requiring both keeps the controller quiet through
transients while still reacting within seconds to a real regression.

`SLO.evaluate(store)` returns an `SLOVerdict` carrying both fractions
and the burning/healthy/no-data verdict; `SLOSet.evaluate` maps a list
of them — the policy layer treats "any throughput-ish SLO burning" as
pressure to grow and "all healthy" as permission to shrink. Verdicts
are plain dicts via ``as_dict()`` so they drop straight into the
``/autoscaler`` decision log.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .timeseries import TimeSeriesStore

__all__ = ["SLO", "SLOVerdict", "SLOSet"]

_KINDS = ("floor", "ceiling")


@dataclass
class SLOVerdict:
    """Outcome of one SLO evaluation at one instant."""

    name: str
    ok: bool                    # True unless burning (no-data counts as ok)
    burning: bool               # both windows exceeded their burn threshold
    fast_fraction: float        # violation fraction over the fast window
    slow_fraction: float        # violation fraction over the slow window
    value: Optional[float]      # newest sampled value (None = no data)
    target: float
    kind: str                   # "floor" | "ceiling"
    detail: str = ""

    def as_dict(self) -> dict:
        return {
            "name": self.name, "ok": self.ok, "burning": self.burning,
            "fast_fraction": round(self.fast_fraction, 4),
            "slow_fraction": round(self.slow_fraction, 4),
            "value": self.value, "target": self.target, "kind": self.kind,
            "detail": self.detail,
        }


@dataclass
class SLO:
    """One objective over one series in a `TimeSeriesStore`.

    ``kind="floor"`` breaches when value < target (throughput floors);
    ``kind="ceiling"`` breaches when value > target (latency / drop-rate
    ceilings). ``mode`` picks what "value" means per evaluation point:

    - ``"value"``: the raw sampled points themselves are compared to the
      target (gauges: p99 latency, drop rate);
    - ``"rate"``: the series is a cumulative counter; the windowed rate
      (fast window) is one scalar compared once — the violation fraction
      collapses to 0.0 or 1.0 per window (frames/s floor over the raw
      ``frames_generated`` counter).

    Burning requires ``fast_fraction >= burn_threshold`` AND
    ``slow_fraction >= burn_threshold`` AND at least ``min_points``
    samples in the slow window — a controller must never page off a
    single point or an empty store.
    """

    name: str
    series: str
    target: float
    kind: str = "ceiling"
    mode: str = "value"                 # "value" | "rate"
    fast_window_s: float = 5.0
    slow_window_s: float = 30.0
    burn_threshold: float = 0.5
    min_points: int = 3

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"SLO kind must be one of {_KINDS}, "
                             f"got {self.kind!r}")
        if self.mode not in ("value", "rate"):
            raise ValueError(f"SLO mode must be 'value' or 'rate', "
                             f"got {self.mode!r}")
        if not (self.fast_window_s > 0 and
                self.slow_window_s >= self.fast_window_s):
            raise ValueError(
                "need 0 < fast_window_s <= slow_window_s, got "
                f"{self.fast_window_s}/{self.slow_window_s}")
        if not 0.0 < self.burn_threshold <= 1.0:
            raise ValueError(
                f"burn_threshold must be in (0, 1], got {self.burn_threshold}")

    def _violates(self, v: float) -> bool:
        return v < self.target if self.kind == "floor" else v > self.target

    def _fraction(self, store: TimeSeriesStore, window_s: float,
                  now: Optional[float]) -> tuple:
        """(violation fraction, points considered) over one window."""
        if self.mode == "rate":
            pts = store.series(self.series).window(window_s, now)
            if len(pts) < 2:
                return 0.0, len(pts)
            r = store.rate(self.series, window_s, now)
            return (1.0 if self._violates(r) else 0.0), len(pts)
        pts = store.series(self.series).window(window_s, now)
        if not pts:
            return 0.0, 0
        bad = sum(1 for _, v in pts if self._violates(v))
        return bad / len(pts), len(pts)

    def evaluate(self, store: TimeSeriesStore,
                 now: Optional[float] = None) -> SLOVerdict:
        fast_f, _ = self._fraction(store, self.fast_window_s, now)
        slow_f, slow_n = self._fraction(store, self.slow_window_s, now)
        latest = store.latest(self.series)
        if self.mode == "rate" and slow_n >= 2:
            latest = store.rate(self.series, self.fast_window_s, now)
        if slow_n < self.min_points:
            return SLOVerdict(
                name=self.name, ok=True, burning=False,
                fast_fraction=fast_f, slow_fraction=slow_f, value=latest,
                target=self.target, kind=self.kind,
                detail=f"no-data ({slow_n}/{self.min_points} points)")
        burning = (fast_f >= self.burn_threshold and
                   slow_f >= self.burn_threshold)
        return SLOVerdict(
            name=self.name, ok=not burning, burning=burning,
            fast_fraction=fast_f, slow_fraction=slow_f, value=latest,
            target=self.target, kind=self.kind,
            detail=("burning" if burning else "healthy"))


@dataclass
class SLOSet:
    """A bundle of SLOs evaluated together; order is preserved so the
    decision log reads stably run over run."""

    slos: List[SLO] = field(default_factory=list)

    def add(self, slo: SLO) -> "SLOSet":
        if any(s.name == slo.name for s in self.slos):
            raise ValueError(f"duplicate SLO name {slo.name!r}")
        self.slos.append(slo)
        return self

    def evaluate(self, store: TimeSeriesStore,
                 now: Optional[float] = None) -> Dict[str, SLOVerdict]:
        return {s.name: s.evaluate(store, now) for s in self.slos}

    @staticmethod
    def any_burning(verdicts: Dict[str, SLOVerdict]) -> bool:
        return any(v.burning for v in verdicts.values())
