"""Utilization sampler + measured bottleneck attribution.

A copy of ``repro.telemetry.sampler`` (pure Python), kept so that the port
imports nothing of the JAX package.

`UtilizationSampler` is a background thread that, every ``interval_s``:

- reads per-process CPU time (utime+stime from ``/proc/<pid>/stat``;
  `resource.getrusage` fallback for the calling process where /proc is
  unavailable) for every watched process — the learner process and each
  spawned actor host — and publishes ``cpu/<name>_cores`` gauges;
- captures a full `MetricsRegistry.snapshot()` (replica counters and
  occupancy, queue-depth gauges, latency histograms) into a bounded tick
  buffer that `TelemetrySink` writes out as ``metrics.jsonl``.

`attribute_bottleneck` is the measured counterpart of the analytic
`repro_torch.core.bottleneck` / `SystemModel` path: it converts runtime signals
into per-frame seconds for the four planes the paper argues over —

- **actor**:    CPU seconds burned by the actor plane (sampled),
- **inference**: device-side forward seconds (replica ``compute_s``),
- **learner**:  train-step seconds (`learner/train_s` histogram),
- **wire**:     client-observed RTT minus the server-side share of it
                (batch wait + perceived forward), i.e. what serialization
                + kernel + scheduling actually cost,

then reports the paper's CPU/GPU ratio (actor-plane CPU per frame over
device-plane seconds per frame) and classifies the window by the largest
share: actor-bound / inference-bound / learner-bound / wire-bound, with
a learner-bound override when the on-policy queue is shedding most of
what the actors generate (the learner is the bottleneck even though it
burns few seconds). Every returned number is finite; an empty window
classifies as "idle" instead of dividing by zero.
"""

import logging
import os
import resource
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Optional

__all__ = ["read_process_cpu_s", "UtilizationSampler", "BottleneckReport",
           "attribute_bottleneck"]

_log = logging.getLogger("repro_torch.telemetry.sampler")

try:
    _CLK_TCK = os.sysconf("SC_CLK_TCK")
except (AttributeError, OSError, ValueError):   # pragma: no cover
    _CLK_TCK = 100


def read_process_cpu_s(pid: int) -> Optional[float]:
    """Total CPU seconds (user+system) consumed by ``pid`` so far.

    Parses fields 14+15 of ``/proc/<pid>/stat`` (searching from the last
    ``)`` so executable names containing spaces/parens cannot shift the
    fields). Falls back to `resource.getrusage` for the calling process;
    returns None for other pids when /proc is unavailable or the process
    is gone.
    """
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            data = f.read()
        rest = data[data.rindex(b")") + 2:].split()
        return (int(rest[11]) + int(rest[12])) / _CLK_TCK
    except (OSError, ValueError, IndexError):
        if pid == os.getpid():
            ru = resource.getrusage(resource.RUSAGE_SELF)
            return ru.ru_utime + ru.ru_stime
        return None


class UtilizationSampler:
    """Background per-process CPU sampler + metrics-snapshot ticker."""

    def __init__(self, metrics, interval_s: float = 0.25,
                 max_ticks: int = 4096):
        self.metrics = metrics
        self.interval_s = interval_s
        self.ticks = deque(maxlen=max_ticks)
        self._procs: Dict[str, int] = {}
        self._base: Dict[str, float] = {}
        self._last: Dict[str, tuple] = {}       # name -> (perf_t, cpu_s)
        self._vanished: set = set()             # names whose pid was reaped
        self._plock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def watch(self, name: str, pid: int):
        """Start tracking a process; CPU totals are measured from now."""
        cpu = read_process_cpu_s(pid)
        with self._plock:
            self._procs[name] = pid
            self._vanished.discard(name)        # re-watch revives a name
            if cpu is not None:
                self._base[name] = cpu
                self._last[name] = (time.perf_counter(), cpu)
        self.metrics.gauge(f"cpu/{name}_cores")

    def sample(self) -> dict:
        """One tick: refresh cpu gauges, snapshot the registry, buffer."""
        now = time.perf_counter()
        with self._plock:
            procs = {n: p for n, p in self._procs.items()
                     if n not in self._vanished}
        cores = {}
        for name, pid in procs.items():
            cpu = read_process_cpu_s(pid)
            if cpu is None:
                # the pid was reaped between ticks (an actor-host child
                # exiting races this read): skip it from now on, log the
                # disappearance ONCE, and never let it raise into — or
                # spin inside — the sampler thread. cpu_totals() keeps
                # serving the last reading taken while it was alive.
                with self._plock:
                    already = name in self._vanished
                    self._vanished.add(name)
                if not already:
                    _log.warning("watched process %r (pid %s) vanished; "
                                 "skipping it from now on", name, pid)
                continue
            last = self._last.get(name)
            with self._plock:
                self._last[name] = (now, cpu)
                self._base.setdefault(name, cpu)
            if last is not None and now > last[0]:
                cores[name] = max(cpu - last[1], 0.0) / (now - last[0])
                self.metrics.gauge(f"cpu/{name}_cores").set(cores[name])
        tick = {"ts": time.time(), "cpu_cores": cores,
                "metrics": self.metrics.snapshot()}
        self.ticks.append(tick)
        return tick

    def cpu_totals(self) -> Dict[str, float]:
        """CPU seconds per watched process since `watch()`. Processes that
        already exited report their last sampled reading — sample once
        more (or call `stop()`) before the children are reaped."""
        with self._plock:
            procs = dict(self._procs)
            base = dict(self._base)
            last = dict(self._last)
            vanished = set(self._vanished)
        out = {}
        for name, pid in procs.items():
            cpu = None if name in vanished else read_process_cpu_s(pid)
            if cpu is None:
                cpu = last.get(name, (0.0, None))[1]
            if cpu is None:
                continue
            out[name] = max(cpu - base.get(name, 0.0), 0.0)
        return out

    # ------------------------------------------------------------ lifecycle

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="telemetry-sampler", daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        self.sample()                    # final tick: catch late counters

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception:            # sampling must never kill the run
                pass


@dataclass
class BottleneckReport:
    """Measured fig-2-style breakdown for one run window."""

    window_s: float
    frames: int
    cpu_gpu_ratio: float                 # actor CPU s/frame over device s/frame
    bottleneck: str                      # {actor,inference,learner,wire}-bound | idle
    seconds_per_frame: Dict[str, float]  # plane -> s/frame
    shares: Dict[str, float]             # plane -> fraction of accounted time
    detail: Dict[str, float] = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"window_s": self.window_s, "frames": self.frames,
                "cpu_gpu_ratio": self.cpu_gpu_ratio,
                "bottleneck": self.bottleneck,
                "seconds_per_frame": dict(self.seconds_per_frame),
                "shares": dict(self.shares), "detail": dict(self.detail)}

    def __str__(self):
        lines = [f"BottleneckReport: {self.bottleneck} "
                 f"(cpu/gpu ratio {self.cpu_gpu_ratio:.2f}, "
                 f"{self.frames} frames over {self.window_s:.2f}s)"]
        for k in ("actor", "inference", "learner", "wire"):
            lines.append(f"  {k:<10} {self.seconds_per_frame.get(k, 0.0):>12.3e} s/frame"
                         f"  ({100.0 * self.shares.get(k, 0.0):5.1f}%)")
        return "\n".join(lines)


def attribute_bottleneck(*, elapsed_s: float, frames: int,
                         actor_cpu_s: float = 0.0,
                         inference_compute_s: float = 0.0,
                         learner_train_s: float = 0.0,
                         wire_overhead_s: float = 0.0,
                         drop_rate: Optional[float] = None,
                         detail: Optional[Dict[str, float]] = None
                         ) -> BottleneckReport:
    """Classify a window from measured totals. Always finite; see module
    docstring for what each plane's seconds mean."""
    per = (1.0 / frames) if frames else 0.0
    spf = {"actor": actor_cpu_s * per,
           "inference": inference_compute_s * per,
           "learner": learner_train_s * per,
           "wire": wire_overhead_s * per}
    total = sum(spf.values())
    shares = {k: (v / total if total > 0 else 0.0) for k, v in spf.items()}
    device = spf["inference"] + spf["learner"]
    ratio = (spf["actor"] / max(device, 1e-12)) if frames else 0.0
    if not frames or total <= 0:
        label = "idle"
    elif drop_rate is not None and drop_rate > 0.5:
        # the queue sheds most generated frames: the learner gates the
        # system even if its measured seconds are small
        label = "learner-bound"
    else:
        label = max(spf, key=spf.get) + "-bound"
    d = dict(detail or {})
    if drop_rate is not None:
        d["drop_rate"] = drop_rate
    return BottleneckReport(window_s=elapsed_s, frames=frames,
                            cpu_gpu_ratio=ratio, bottleneck=label,
                            seconds_per_frame=spf, shares=shares, detail=d)
