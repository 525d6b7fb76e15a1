"""TelemetrySink: write the run's observables to disk.

A copy of ``repro.telemetry.sink`` (pure Python), kept so that the port
imports nothing of the JAX package.

Two artifacts per run directory:

- ``trace.json`` — Chrome trace-event JSON (load in Perfetto or
  chrome://tracing): every span from every traced process, plus flow
  arrows stitching each wire round-trip across process tracks.
- ``metrics.jsonl`` — one JSON object per sampler tick: schema version,
  monotonic tick index, wall-clock ts, per-process cpu cores, and a full
  registry snapshot (counters, gauges, histograms with p50/p95/p99).

Both artifacts are written ATOMICALLY: content goes to a same-directory
temp file first, then `os.replace` publishes it — a crash mid-dump (the
flight recorder triggering while a dump is in flight, a SIGKILL'd CI
job) can never leave a truncated trace.json that Perfetto rejects or a
half-line in metrics.jsonl. Readers either see the previous complete
artifact or the new complete one.

`merge_bench_json` is the fig3/fig4 helper: both benchmarks append their
measured section into ONE ``BENCH_telemetry.json`` keyed by benchmark
name, so re-running either refreshes its own section without clobbering
the other's.
"""

import json
import os
from typing import Callable, Dict, List, Optional

__all__ = ["TelemetrySink", "merge_bench_json", "append_bench_history",
           "bench_commit", "METRICS_SCHEMA_VERSION"]

# bump when the shape of a metrics.jsonl line changes; consumers key
# their parsing on the per-line "schema" stamp
METRICS_SCHEMA_VERSION = 1


def _atomic_write(path: str, write_fn: Callable) -> None:
    """Write via temp file + `os.replace` (atomic on POSIX within one
    filesystem — the temp lives next to the target to guarantee that)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            write_fn(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):          # only on a failed write
            try:
                os.remove(tmp)
            except OSError:
                pass


class TelemetrySink:
    def __init__(self, out_dir: str = "."):
        self.out_dir = out_dir

    def dump(self, trace_events: List[dict], metric_lines: List[dict],
             out_dir: Optional[str] = None) -> Dict[str, str]:
        out = out_dir or self.out_dir
        os.makedirs(out, exist_ok=True)
        trace_path = os.path.join(out, "trace.json")
        _atomic_write(trace_path, lambda f: json.dump(
            {"traceEvents": trace_events, "displayTimeUnit": "ms"}, f))
        metrics_path = os.path.join(out, "metrics.jsonl")

        def _write_lines(f):
            for i, line in enumerate(metric_lines):
                stamped = {"schema": METRICS_SCHEMA_VERSION, "tick": i}
                stamped.update(line)
                f.write(json.dumps(stamped) + "\n")

        _atomic_write(metrics_path, _write_lines)
        return {"trace": trace_path, "metrics": metrics_path}


def merge_bench_json(path: str, key: str, payload: dict) -> dict:
    """Read-modify-write ``path`` setting ``doc[key] = payload``."""
    doc = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            doc = {}
    if not isinstance(doc, dict):
        doc = {}
    doc[key] = payload

    def _write(f):
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")

    _atomic_write(path, _write)
    return doc


def bench_commit() -> str:
    """Best-effort commit id for bench history entries: the checkout's
    HEAD, else the CI-provided sha, else 'unknown' (never raises)."""
    sha = os.environ.get("GITHUB_SHA", "")
    try:
        import subprocess
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5.0,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except Exception:
        pass
    return sha[:12] if sha else "unknown"


def append_bench_history(path: str, key: str, entry: dict,
                         keep: int = 50) -> list:
    """Append one measured point to ``doc[key]`` (a list) in the shared
    bench-history ledger, keeping the last ``keep`` entries.

    This is the trend guard's data source (`benchmarks/check_trend.py`):
    each fig3/fig4 run appends ``{"commit", "ts", "frames_per_s", ...}``
    so a throughput regression shows up as a comparable series, not a
    silent drift. The file is separate from the `merge_bench_json`
    sections (which are wholesale-replaced per run) precisely so history
    survives re-runs."""
    doc = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            doc = {}
    if not isinstance(doc, dict):
        doc = {}
    hist = doc.get(key)
    if not isinstance(hist, list):
        hist = []
    hist.append(dict(entry))
    hist = hist[-max(int(keep), 1):]
    doc[key] = hist

    def _write(f):
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")

    _atomic_write(path, _write)
    return hist
