"""repro_torch.telemetry — the measurement plane for the SEED-style system.

A copy of ``repro.telemetry`` (pure Python), kept so that the port
imports nothing of the JAX package. The learner process's seconds that
`Telemetry.bottleneck_report` nets out of its CPU (``compute_s``,
``learner/train_s``) are host-clock seconds around work that waits for the
card, so whether they also show up as CPU time depends on how the CUDA
synchronise waits; the reference's formula is kept as it is.

The source paper's method IS measurement: find which plane (actor CPU,
inference device, learner device, interconnect) gates throughput and
provision the CPU/GPU ratio accordingly. This package turns the repo's
after-the-fact counter dumps into first-class runtime observables.

Decision matrix — which instrument for which question:

==============  =====================================  ====================
Instrument      Question it answers                    Overhead
==============  =====================================  ====================
`Tracer`        *When/where did THIS request go?*      disabled: one attr
(spans)         Per-event timelines, cross-process     check returning a
                stitching by wire trace_seq, Perfetto  cached no-op span;
                visualization. Bounded ring: keeps     enabled: 2 clock
                the newest window, drops the oldest.   reads + a GIL-atomic
                                                       deque append/span.
`MetricsRegistry` *How is the system doing overall?*   one shared lock per
(counters/      Totals, rates, occupancy, queue        update or batched
gauges/         depths, p50/p95/p99 latency            update group; hot
histograms)     distributions. Never drops, no         loops take it once
                per-event memory — aggregates only.    per batch.
`UtilizationSampler` *What is the hardware doing?*     one /proc read per
(+ reports)     Per-process CPU cores, periodic        watched process per
                registry snapshots (metrics.jsonl),    tick (default 4 Hz);
                measured `BottleneckReport`/CPU-GPU    zero cost between
                ratio.                                 ticks.
`OpsServer`     *What is it doing RIGHT NOW — online   one HTTP thread,
(+ health/      vs offline?* Online: /metrics          work only per
audit plane)    Prometheus scrape, /healthz liveness   scrape; watchdog +
                verdict, /varz live BottleneckReport;  auditor are two
                heartbeat watchdog + invariant         ~4 Hz snapshot-
                auditor watch the run as it happens.   read threads;
                Offline twin: `TelemetrySink.dump()`   heartbeats are one
                trace.json + metrics.jsonl, written    dict store per
                after the run for post-hoc analysis.   loop iteration.
==============  =====================================  ====================

Rules of thumb: count it in the registry if you will alert or scale on
it; trace it if you will ever ask "why was this one slow"; sample it if
only the OS knows. The tracer is a debugging window (lossy by design);
the registry is the ledger (lossless, aggregate-only); the sampler is
the bridge to the paper's utilization story.

`Telemetry` bundles the three plus a `TelemetrySink`:

    from repro_torch.telemetry import Telemetry
    tel = Telemetry(process_name="learner")
    sys_ = SeedSystem(..., telemetry=tel)
    stats = sys_.run(seconds=5)
    print(tel.bottleneck_report(stats))      # actor-bound? wire-bound?
    tel.dump("runs/exp1")                    # trace.json + metrics.jsonl

On the socket/shm transports each spawned actor host builds its own
`Telemetry` (same trace_seq ids ride the wire v3 headers), ships its
spans and registry snapshot back through the result queue, and the
parent absorbs them — `dump()` then writes ONE trace with every process
on a shared CLOCK_MONOTONIC timeline and flow arrows stitching each
round-trip actor → gateway → replica → reply.
"""

import os
import threading
import time
from typing import Dict, List, Optional

from .audit import InvariantAuditor
from .flightrec import FlightRecorder
from .health import HealthReport, HeartbeatRegistry, Watchdog
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .ops import (OpsServer, parse_prometheus, render_prometheus,
                  sanitize_metric_name, validate_prometheus)
from .sampler import (BottleneckReport, UtilizationSampler,
                      attribute_bottleneck, read_process_cpu_s)
from .sink import (TelemetrySink, append_bench_history, bench_commit,
                   merge_bench_json)
from .slo import SLO, SLOSet, SLOVerdict
from .timeseries import TimeSeries, TimeSeriesStore
from .tracer import Tracer, chrome_trace, flow_events, next_trace_seq

__all__ = [
    "Telemetry", "Tracer", "MetricsRegistry", "Counter", "Gauge",
    "Histogram", "UtilizationSampler", "BottleneckReport",
    "attribute_bottleneck", "read_process_cpu_s", "TelemetrySink",
    "merge_bench_json", "append_bench_history", "bench_commit",
    "next_trace_seq", "flow_events", "chrome_trace",
    "HeartbeatRegistry", "HealthReport", "Watchdog", "FlightRecorder",
    "InvariantAuditor", "OpsServer", "render_prometheus",
    "parse_prometheus", "validate_prometheus", "sanitize_metric_name",
    "TimeSeries", "TimeSeriesStore", "SLO", "SLOSet", "SLOVerdict",
]


class Telemetry:
    """One run's tracer + metrics registry + sampler + sink, wired for
    `SeedSystem(telemetry=...)`. See the module docstring."""

    def __init__(self, enabled: bool = True, process_name: str = "learner",
                 trace_capacity: int = 32768, sample_interval_s: float = 0.25,
                 out_dir: str = "."):
        self.enabled = enabled
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(enabled=enabled, capacity=trace_capacity,
                             process_name=process_name)
        self.sampler = UtilizationSampler(self.metrics,
                                          interval_s=sample_interval_s)
        self.sink = TelemetrySink(out_dir)
        self._extra_events: List[dict] = []
        self._host_snapshots: List[dict] = []
        self._extra_registries: Dict[str, MetricsRegistry] = {}
        self._lock = threading.Lock()

        # live ops plane: heartbeat liveness, crash postmortems,
        # continuous invariant audits, HTTP export. The watchdog/auditor
        # threads only run while the ops plane is active (serve_ops);
        # the flight recorder and heartbeat stamps are always armed.
        self.health = HeartbeatRegistry()
        self.flightrec = FlightRecorder(
            out_dir=os.path.join(out_dir, "crashes"), enabled=enabled)
        self.flightrec.add_provider("metrics", self.merged_snapshot)
        self.flightrec.add_provider(
            "health", lambda: self.health.report().as_dict())
        self.flightrec.add_provider(
            "bottleneck", lambda: self.bottleneck_report({}).as_dict())
        self.flightrec.set_trace_source(self.trace_events, chrome_trace)
        self.watchdog = Watchdog(
            self.health,
            on_unhealthy=lambda rep: self.flightrec.trigger(
                f"watchdog_{rep.verdict}", str(rep)))
        self.auditor = InvariantAuditor(
            interval_s=sample_interval_s, on_violation=self._audit_violation)
        self.auditor.watch_registry("main", self.metrics)
        self.ops: Optional[OpsServer] = None

    def _audit_violation(self, check: str, msg: str):
        """Auditor escalation: violation -> health event + postmortem."""
        self.health.event(check, msg)
        self.flightrec.trigger("audit_violation", f"{check}: {msg}")

    # ----------------------------------------------------------- lifecycle

    def start(self):
        """Watch the calling (learner) process and start the sampler;
        with the ops plane active, also the watchdog + auditor."""
        if not self.enabled:
            return
        self.sampler.watch("learner", os.getpid())
        self.sampler.start()
        if self.ops is not None:
            self.watchdog.start()
            self.auditor.start()

    def stop(self):
        if not self.enabled:
            return
        self.watchdog.stop()
        self.auditor.stop()
        self.sampler.stop()
        # the ops server intentionally outlives stop(): a post-run scrape
        # must still see the final (now quiescent) state — close_ops()
        # tears it down.

    def serve_ops(self, host: str = "127.0.0.1", port: int = 0):
        """Start (or return) the ops HTTP server; (host, port) tuple."""
        if self.ops is None:
            self.ops = OpsServer(self, host=host, port=port)
        if self.ops.address is None:
            self.ops.start()
        return self.ops.address

    def close_ops(self):
        ops, self.ops = self.ops, None
        if ops is not None:
            ops.stop()

    def watch_process(self, name: str, pid: int):
        """Register a child process (actor host) for CPU sampling."""
        if self.enabled:
            self.sampler.watch(name, pid)

    def attach(self, name: str, registry: MetricsRegistry):
        """Include another registry (e.g. a gateway's private one) in
        snapshots, reports, metrics.jsonl — and the continuous audit."""
        with self._lock:
            self._extra_registries[name] = registry
        self.auditor.watch_registry(name, registry)

    # ----------------------------------------------------------- ingestion

    def absorb_host(self, host_stats: dict):
        """Fold a spawned actor host's telemetry (shipped through the mp
        result queue) into this run; pops the bulky keys so the stats
        dict stays a plain counter report."""
        events = host_stats.pop("trace_events", None)
        snap = host_stats.pop("metrics_snapshot", None)
        with self._lock:
            if events:
                self._extra_events.extend(events)
            if snap:
                self._host_snapshots.append(
                    {"ts": time.time(),
                     "host": host_stats.get("host_id"), "metrics": snap})

    # ------------------------------------------------------------- queries

    def trace_events(self) -> List[dict]:
        """All spans (local + absorbed hosts) plus stitching flow events."""
        events = self.tracer.export_events()
        with self._lock:
            events = events + list(self._extra_events)
        return events + flow_events(events)

    def metrics_lines(self) -> List[dict]:
        lines = list(self.sampler.ticks)
        if not lines:                       # sampler never ran: one snapshot
            lines = [{"ts": time.time(), "cpu_cores": {},
                      "metrics": self.metrics.snapshot()}]
        with self._lock:
            lines = lines + list(self._host_snapshots)
            for name, reg in self._extra_registries.items():
                lines.append({"ts": time.time(), "registry": name,
                              "metrics": reg.snapshot()})
        return lines

    def merged_snapshot(self) -> dict:
        """One registry-shaped snapshot spanning every process and plane:
        own registry + attached (gateway) registries + absorbed actor-host
        snapshots. Counters with the same name SUM (e.g. ``gateway/...``
        across G gateways, ``host_wire/...`` across hosts), histograms
        merge exactly via `Histogram.merge_snapshots`, and for gauges the
        first-seen value wins (the learner process's own registry has
        priority). This is what /metrics renders."""
        snaps = [self.metrics.snapshot()]
        with self._lock:
            for reg in self._extra_registries.values():
                snaps.append(reg.snapshot())
            snaps.extend(e["metrics"] for e in self._host_snapshots)
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, List[dict]] = {}
        for s in snaps:
            for k, v in s.get("counters", {}).items():
                counters[k] = counters.get(k, 0.0) + v
            for k, v in s.get("gauges", {}).items():
                gauges.setdefault(k, v)
            for k, h in s.get("histograms", {}).items():
                hists.setdefault(k, []).append(h)
        merged_h = {}
        for k, hs in hists.items():
            try:
                m = Histogram.merge_snapshots(hs)
            except ValueError:               # mismatched v0: keep local view
                m = hs[0]
            if m:
                merged_h[k] = m
        return {"counters": counters, "gauges": gauges,
                "histograms": merged_h}

    def merged_histogram(self, name: str) -> Optional[dict]:
        """Merge a named histogram across this process and every absorbed
        actor-host snapshot (e.g. ``wire/rtt_s`` lives client-side)."""
        snaps = []
        own = self.metrics.snapshot()["histograms"].get(name)
        if own:
            snaps.append(own)
        with self._lock:
            for entry in self._host_snapshots:
                h = entry["metrics"].get("histograms", {}).get(name)
                if h:
                    snaps.append(h)
        return Histogram.merge_snapshots(snaps)

    def _counter_total(self, suffix: str) -> float:
        snap = self.metrics.snapshot()["counters"]
        return float(sum(v for k, v in snap.items() if k.endswith(suffix)))

    # -------------------------------------------------------------- report

    def bottleneck_report(self, stats: Optional[dict] = None
                          ) -> BottleneckReport:
        """Measured CPU/GPU-ratio breakdown for the run so far. ``stats``
        is the dict `SeedSystem.run()`/`throughput()` returns; without it
        the report falls back to registry counters only."""
        stats = stats or {}
        lanes = self._counter_total("/requests")
        batches = self._counter_total("/batches")
        rpcs = self._counter_total("/rpcs")
        compute_s = self._counter_total("/compute_s")
        wait_s = self._counter_total("/queue_wait_s")
        frames = int(stats.get("env_frames", lanes))
        elapsed = float(stats.get("elapsed_s", 0.0))

        train_hist = self.metrics.snapshot()["histograms"].get(
            "learner/train_s")
        train_s = float(train_hist["sum"]) if train_hist else 0.0

        totals = self.sampler.cpu_totals()
        host_cpu = sum(v for k, v in totals.items()
                       if k.startswith("actor-host"))
        if host_cpu > 0:
            actor_cpu = host_cpu
        else:
            # in-proc backends: actors share the watched learner process,
            # so attribute its CPU net of the device-plane seconds we can
            # account for (documented approximation)
            actor_cpu = max(totals.get("learner", 0.0) - compute_s - train_s,
                            0.0)

        # wire = what the client waited beyond the server-side share of
        # the round-trip (per-rpc: mean lane wait + perceived forward)
        wire_s = 0.0
        rtt = self.merged_histogram("wire/rtt_s")
        if rtt and rtt["count"]:
            server_per_rpc = 0.0
            if lanes:
                server_per_rpc += wait_s / lanes
            if batches:
                server_per_rpc += compute_s / batches
            wire_s = max(rtt["mean"] - server_per_rpc, 0.0) * rtt["count"]

        onp = stats.get("onpolicy")
        drop = onp.get("drop_rate") if isinstance(onp, dict) else None
        detail = {"actor_cpu_s": actor_cpu, "inference_compute_s": compute_s,
                  "inference_batch_wait_s": wait_s, "learner_train_s": train_s,
                  "wire_overhead_s": wire_s, "inference_rpcs": rpcs,
                  "wire_rtt_p50": rtt.get("p50") if rtt else None,
                  "cpu_cores": {k: round(v, 3) for k, v in totals.items()}}
        return attribute_bottleneck(
            elapsed_s=elapsed, frames=frames, actor_cpu_s=actor_cpu,
            inference_compute_s=compute_s, learner_train_s=train_s,
            wire_overhead_s=wire_s, drop_rate=drop, detail=detail)

    # ---------------------------------------------------------------- dump

    def dump(self, out_dir: Optional[str] = None) -> Dict[str, str]:
        """Write trace.json + metrics.jsonl; returns their paths."""
        return self.sink.dump(self.trace_events(), self.metrics_lines(),
                              out_dir=out_dir)
