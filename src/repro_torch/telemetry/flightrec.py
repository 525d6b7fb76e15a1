"""Flight recorder: postmortem bundles from every fail-fast path.

A copy of ``repro.telemetry.flightrec`` (pure Python), kept so that the port
imports nothing of the JAX package.

The system's failure discipline is fail-fast — `InferenceServer._fatal`
poisons in-flight work, a gateway sever tears down the wire, the pool's
hard timeout raises. What fails fast also *forgets* fast: by the time a
test harness or operator looks, the span rings, metrics, and thread
stacks that explain the crash are gone with the process. The flight
recorder is the hook each of those paths calls on the way down: it
freezes the observable state into a bundle directory

    {out_dir}/postmortem-{reason}-{seq:03d}/
        manifest.json     reason, detail, wall time, pid
        stacks.txt        sys._current_frames() of every live thread
        trace.json        Chrome trace of the current span rings
        metrics.json      merged MetricsRegistry snapshot
        health.json       HealthReport at time of death
        bottleneck.json   BottleneckReport at time of death

Two properties matter more than completeness:

- **`trigger` never raises.** It runs inside `_fatal` and the watchdog;
  a postmortem failure must not mask the original error. Every provider
  call and every write is individually guarded.
- **Rate-limited.** Fail-fast paths cascade (a replica fatal poisons
  every actor, which each see a `ReplyError`): per-reason cooldown plus
  a global bundle cap turn a cascade into one bundle per root cause.

Bundles are staged in a temp directory and `os.rename`d into place, so
a reader never sees a half-written bundle — the same atomicity
discipline as `TelemetrySink.dump`. Where a bundle of the same name is
already there (an earlier run, or another recorder in the same
directory), the port's copy adds ``.2``, ``.3``, ... to the name.
"""

import json
import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

__all__ = ["FlightRecorder"]


def _dump_stacks() -> str:
    """Format every live thread's current stack, labelled by thread name
    — the wedged frame is usually the whole diagnosis."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(tid, '?')} (tid={tid}) ---")
        out.append("".join(traceback.format_stack(frame)))
    return "\n".join(out)


class FlightRecorder:
    """Write-once crash bundles; see module docstring.

    Providers are registered by `Telemetry` (metrics/health/bottleneck
    report callables) plus a trace-event source; `trigger(reason,
    detail)` snapshots them all. `bundles` lists the paths written, for
    tests and the `/varz` endpoint."""

    def __init__(self, out_dir: str = "crashes", enabled: bool = True,
                 max_bundles: int = 8, per_reason_cooldown_s: float = 5.0):
        self.out_dir = out_dir
        self.enabled = enabled
        self.max_bundles = max_bundles
        self.per_reason_cooldown_s = per_reason_cooldown_s
        self.bundles: List[str] = []
        self.dropped = 0                  # triggers suppressed by limits
        self._providers: Dict[str, Callable[[], object]] = {}
        self._trace_source: Optional[Callable[[], list]] = None
        self._chrome: Optional[Callable[[list], dict]] = None
        self._last_fire: Dict[str, float] = {}
        self._seq = 0
        self._lock = threading.Lock()

    def add_provider(self, name: str, fn: Callable[[], object]):
        """Register a JSON-serializable snapshot source, written to
        `{name}.json` in each bundle."""
        self._providers[name] = fn

    def set_trace_source(self, events_fn: Callable[[], list],
                         chrome_fn: Callable[[list], dict]):
        self._trace_source = events_fn
        self._chrome = chrome_fn

    def trigger(self, reason: str, detail: str = "") -> Optional[str]:
        """Write a postmortem bundle; returns its path, or None when
        disabled/rate-limited/failed. NEVER raises — this runs inside
        the fail-fast paths themselves."""
        try:
            return self._trigger(reason, detail)
        except Exception:
            return None

    # ----------------------------------------------------------- internals

    def _trigger(self, reason: str, detail: str) -> Optional[str]:
        if not self.enabled:
            return None
        now = time.perf_counter()
        with self._lock:
            last = self._last_fire.get(reason)
            if len(self.bundles) >= self.max_bundles or (
                    last is not None
                    and now - last < self.per_reason_cooldown_s):
                self.dropped += 1
                return None
            self._last_fire[reason] = now
            self._seq += 1
            seq = self._seq

        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason) or "unknown"
        final = os.path.join(self.out_dir, f"postmortem-{safe}-{seq:03d}")
        n = 1
        while os.path.exists(final) or os.path.exists(final + ".tmp"):
            # an earlier run's bundle, or another recorder's in the same
            # directory: the reference's rename fails there and the
            # postmortem is lost
            n += 1
            final = os.path.join(self.out_dir,
                                 f"postmortem-{safe}-{seq:03d}.{n}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)

        def _write(name, payload, raw=False):
            try:
                with open(os.path.join(tmp, name), "w") as f:
                    if raw:
                        f.write(payload)
                    else:
                        json.dump(payload, f, indent=1, default=str)
            except Exception:
                pass                     # a bad provider must not kill the rest

        _write("manifest.json", {
            "reason": reason, "detail": detail, "seq": seq,
            "pid": os.getpid(), "wall_time": time.time(),
            "perf_counter": now,
        })
        _write("stacks.txt", _dump_stacks(), raw=True)
        if self._trace_source is not None and self._chrome is not None:
            try:
                _write("trace.json", self._chrome(self._trace_source()))
            except Exception:
                pass
        for name, fn in self._providers.items():
            try:
                _write(f"{name}.json", fn())
            except Exception:
                pass
        try:
            os.rename(tmp, final)
        except OSError:
            return None
        with self._lock:
            self.bundles.append(final)
        return final
