"""Bench trend guard: fail on a frames/s collapse vs recorded history.

A copy of the JAX package's ``benchmarks/check_trend.py`` (pure Python),
kept so that the port imports nothing of it; the lines and exit codes are
the same. The port's fig3/fig4 smoke runs append one ``{"commit", "ts",
"frames_per_s"}`` entry per run into ``BENCH_history.json`` under their
output directory (see `repro_torch.telemetry.sink.append_bench_history`). This checker reads one or
more of those ledgers and FAILS (exit 1) when any series' latest point
has regressed more than ``--tolerance`` (default 25%) below the best
point ever recorded in that series.

Single-entry series pass trivially — a fresh CI checkout has no history
to regress against, so the guard is inert there and bites where history
accumulates: a developer checkout, a persisted CI cache, or a committed
ledger. Missing files are skipped with a note (exit 0): the guard must
never turn "bench did not run" into a fake regression.

Usage:
    PYTHONPATH=src python -m repro_torch.benchmarks.check_trend [paths...] [--tolerance 0.25]

Default path: the port's ledger, ``build/bench_torch/BENCH_history.json``
under the repo root (the fig3/fig4 modules' default output directory).
"""

import argparse
import json
import os
import sys
from pathlib import Path

DEFAULT_PATH = str(Path(__file__).resolve().parents[3] / "build" / "bench_torch" /
                   "BENCH_history.json")


def check_series(name: str, entries: list, tolerance: float) -> list:
    """Return failure strings for one history series (empty = pass)."""
    points = [(e.get("commit", "?"), e["frames_per_s"]) for e in entries
              if isinstance(e, dict)
              and isinstance(e.get("frames_per_s"), (int, float))
              and e["frames_per_s"] > 0]
    if len(points) < 2:
        print(f"trend_{name},skip,{len(points)} usable point(s) — "
              f"nothing to compare")
        return []
    best_commit, best = max(points, key=lambda p: p[1])
    last_commit, last = points[-1]
    floor = (1.0 - tolerance) * best
    verdict = "ok" if last >= floor else "FAIL"
    print(f"trend_{name},{verdict},last={last:.1f}fps@{last_commit} "
          f"best={best:.1f}fps@{best_commit} floor={floor:.1f} "
          f"({len(points)} points)")
    if last < floor:
        return [f"{name}: latest {last:.1f} frames/s ({last_commit}) is "
                f">{tolerance:.0%} below best recorded {best:.1f} "
                f"({best_commit})"]
    return []


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("paths", nargs="*", default=None,
                    help="BENCH_history.json ledgers (missing files are "
                         "skipped)")
    ap.add_argument("--tolerance", type=float, default=0.25,
                    help="allowed fractional drop vs the best recorded "
                         "frames/s (default 0.25)")
    args = ap.parse_args(argv)
    if not 0.0 < args.tolerance < 1.0:
        ap.error(f"--tolerance must be in (0, 1), got {args.tolerance}")
    paths = args.paths or [DEFAULT_PATH]

    print("# bench trend guard: latest frames/s vs best recorded")
    print("name,verdict,derived")
    failures = []
    seen_any = False
    for path in paths:
        path = os.path.normpath(path)
        if not os.path.exists(path):
            print(f"trend_file,skip,{path} does not exist")
            continue
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as exc:
            failures.append(f"{path}: unreadable history ledger ({exc})")
            continue
        if not isinstance(doc, dict):
            failures.append(f"{path}: history ledger is not a JSON object")
            continue
        for key in sorted(doc):
            if isinstance(doc[key], list):
                seen_any = True
                failures.extend(
                    check_series(key, doc[key], args.tolerance))
    if not seen_any and not failures:
        print("trend_summary,skip,no history series found")
        return 0
    if failures:
        for f_ in failures:
            print(f"trend_FAIL,1,{f_}")
        return 1
    print("trend_summary,ok,no series regressed past tolerance")
    return 0


if __name__ == "__main__":
    sys.exit(main())
