"""Per-thread ring-buffer span tracer with Chrome trace-event export.

A copy of ``repro.telemetry.tracer`` (standard library only): the port
keeps its own so that it imports nothing of the JAX package.

Design constraints, in priority order:

1. **Near-zero cost disabled.** `trace_span()` on a disabled tracer
   returns a cached no-op context manager after one attribute check — no
   allocation, no clock read, no lock. Instrumented hot loops hoist
   ``tr = self._tracer`` and branch on ``tr is not None`` so the disabled
   path is one local-load + jump.
2. **Lock-free-ish enabled path.** Each thread records into its own
   `deque(maxlen=capacity)` ring (CPython deque append is atomic under
   the GIL); the tracer's lock is only taken once per thread (ring
   registration) and at export. Wraparound silently drops the OLDEST
   spans — tracing is a window, not a ledger.
3. **Cross-process stitching.** Timestamps come from
   `time.perf_counter_ns()` — CLOCK_MONOTONIC on Linux, one timebase for
   every process on the host — so spans recorded in spawned actor-host
   processes line up with learner-side spans on one Perfetto timeline.
   A u32 sequence id from `next_trace_seq()` (pid-salted so concurrent
   processes don't collide) rides the wire v3 frame header; every span
   touched by that logical request records the same seq, and
   `flow_events()` turns each seq group into Chrome flow arrows
   ("s"/"t"/"f" events sharing an ``id``) across process tracks.

Export is the Chrome trace-event JSON array format (``{"traceEvents":
[...]}``): "X" complete events with microsecond ``ts``/``dur``, "M"
metadata events naming each process/thread track — load the file at
ui.perfetto.dev or chrome://tracing.
"""

import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

__all__ = ["Tracer", "next_trace_seq", "flow_events", "chrome_trace"]

_now_ns = time.perf_counter_ns

_seq_counter = itertools.count(1)


def next_trace_seq() -> int:
    """Allocate a u32 trace-sequence id, unique enough within one run:
    10 pid bits salt the top so ids minted concurrently in different
    processes (actor hosts) don't collide, 22 counter bits roll within a
    process. 0 is reserved for "untraced" and never returned."""
    seq = ((os.getpid() & 0x3FF) << 22) | (next(_seq_counter) & 0x3FFFFF)
    return seq or 1


class _NullSpan:
    """Shared no-op span: the entire disabled-tracer hot path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_seq", "_args", "_t0")

    def __init__(self, tracer, name, seq, args):
        self._tracer = tracer
        self._name = name
        self._seq = seq
        self._args = args

    def __enter__(self):
        self._t0 = _now_ns()
        return self

    def __exit__(self, *exc):
        t0 = self._t0
        self._tracer.record(self._name, t0, _now_ns() - t0, self._seq,
                            self._args)
        return False


class Tracer:
    """Span recorder; one ring per recording thread. See module docstring."""

    def __init__(self, enabled: bool = True, capacity: int = 32768,
                 process_name: Optional[str] = None):
        self.enabled = enabled
        self.capacity = capacity
        self.pid = os.getpid()
        self.process_name = process_name or f"pid-{self.pid}"
        self._local = threading.local()
        self._rings: List[Tuple[int, str, deque]] = []
        self._lock = threading.Lock()

    def _ring(self) -> deque:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            t = threading.current_thread()
            ring = deque(maxlen=self.capacity)
            self._local.ring = ring
            with self._lock:
                self._rings.append((t.ident or 0, t.name, ring))
        return ring

    # ------------------------------------------------------------ recording

    def trace_span(self, name: str, seq: int = 0, args: Optional[dict] = None):
        """Context manager timing one same-thread span."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, seq, args)

    def begin(self, name: str, seq: int = 0):
        """Start a span that another thread (or a later point in this one)
        will `end()`. Returns an opaque token, or None when disabled."""
        if not self.enabled:
            return None
        return (name, seq, _now_ns())

    def end(self, token, args: Optional[dict] = None):
        """Finish a `begin()` token; records into the ENDING thread's ring
        (that is the track the span renders on)."""
        if token is None:
            return
        name, seq, t0 = token
        self.record(name, t0, _now_ns() - t0, seq, args)

    def record(self, name: str, t0_ns: int, dur_ns: int, seq: int = 0,
               args: Optional[dict] = None):
        """Append an already-measured span (e.g. a queue wait computed from
        a request's enqueue stamp)."""
        if not self.enabled:
            return
        self._ring().append((name, t0_ns, dur_ns, seq, args))

    # -------------------------------------------------------------- export

    def span_count(self) -> int:
        with self._lock:
            rings = list(self._rings)
        return sum(len(r) for _, _, r in rings)

    def export_events(self) -> List[dict]:
        """Chrome trace events for everything currently in the rings:
        process/thread "M" metadata plus one "X" complete event per span
        (ts/dur in microseconds, as the format requires)."""
        events: List[dict] = [{
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": self.process_name},
        }]
        with self._lock:
            rings = list(self._rings)
        for tid, tname, ring in rings:
            events.append({"name": "thread_name", "ph": "M", "pid": self.pid,
                           "tid": tid, "args": {"name": tname}})
            for name, t0, dur, seq, args in list(ring):
                ev = {"name": name, "ph": "X", "ts": t0 / 1e3,
                      "dur": max(dur, 1) / 1e3, "pid": self.pid, "tid": tid}
                if seq or args:
                    a = dict(args) if args else {}
                    if seq:
                        a["trace_seq"] = seq
                    ev["args"] = a
                events.append(ev)
        return events


def flow_events(events: List[dict]) -> List[dict]:
    """Stitch: for every trace_seq shared by >= 2 "X" events, emit a Chrome
    flow ("s" start / "t" step / "f" finish, one shared ``id``) binding
    those slices — across threads AND processes — into one arrowed track."""
    groups: Dict[int, List[dict]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        seq = (ev.get("args") or {}).get("trace_seq")
        if seq:
            groups.setdefault(seq, []).append(ev)
    out: List[dict] = []
    for seq, evs in sorted(groups.items()):
        if len(evs) < 2:
            continue
        evs.sort(key=lambda e: e["ts"])
        last = len(evs) - 1
        for i, ev in enumerate(evs):
            ph = "s" if i == 0 else ("f" if i == last else "t")
            flow = {"name": "roundtrip", "cat": "roundtrip", "ph": ph,
                    "id": seq, "ts": ev["ts"], "pid": ev["pid"],
                    "tid": ev["tid"]}
            if ph == "f":
                flow["bp"] = "e"   # bind to the enclosing slice
            out.append(flow)
    return out


def chrome_trace(events: List[dict]) -> dict:
    """Wrap events in the JSON-object trace format Perfetto expects."""
    return {"traceEvents": events, "displayTimeUnit": "ms"}
