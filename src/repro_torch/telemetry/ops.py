"""Live ops plane: stdlib-only HTTP export of the telemetry state.

A copy of ``repro.telemetry.ops`` (pure Python), kept so that the port
imports nothing of the JAX package.

The rest of the telemetry is dump-at-the-end; this module is the *online*
half — the piece GA3C-style runtime tuning and the autoscaler need.
`OpsServer` runs one `ThreadingHTTPServer` thread (loopback by default,
``port=0`` = ephemeral) over a `Telemetry` bundle and serves:

- ``/metrics``  — Prometheus text exposition (version 0.0.4) of the
  merged registry snapshot: own registry + attached gateway registries +
  absorbed actor-host snapshots (counters sum, histograms merge exactly
  via `Histogram.merge_snapshots`, first-seen gauge wins so the learner
  process's view has priority). Registered *collectors* contribute extra
  gauges; each collector runs per scrape, so a collector that reads one
  `TrajectoryQueue.stats()` call exports a frame ledger that is conserved
  WITHIN the scrape — individual callback gauges cannot promise that.
- ``/healthz``  — JSON `HealthReport`; HTTP 200 only when ``healthy``
  (503 otherwise) so a plain probe needs no body parsing.
- ``/varz``     — one JSON blob of everything live: `throughput()` stats
  (ledger, per-replica occupancy, bottleneck report), health, postmortem
  bundle paths. The autoscaler's input document.
- ``/trace``    — Chrome trace JSON of the current span rings, on
  demand, without waiting for `dump()`.
- ``/autoscaler`` — the elastic control plane's append-only decision
  log + live topology (`AutoscaleController.dump()`): every resize with
  the series values, bottleneck class and SLO verdicts that justified
  it. 404s with a hint until a controller registers.
- ``/timeseries`` — windowed dump of every `TimeSeriesStore` series
  (``?window=<seconds>`` narrows it) — the raw points behind the
  autoscaler's decisions, for external plotting/debugging.

The scrape path does work only per-request (a snapshot + string build);
an idle ops server costs one blocked `accept`. Everything is stdlib —
no prometheus_client dependency — so the renderer has an in-repo
round-trip check: `parse_prometheus` / `validate_prometheus` (used by
the fig3 CI gate) verify name charset, TYPE declarations, histogram
bucket monotonicity and ``+Inf == _count`` on every exposition we emit.
"""

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

from .tracer import chrome_trace

__all__ = ["OpsServer", "render_prometheus", "parse_prometheus",
           "validate_prometheus", "sanitize_metric_name"]

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE = re.compile(                    # name{labels} value — the label
    # group is GREEDY to the last '}' so quoted label values may contain
    # a raw '}' (legal in the exposition format; only \ " need escaping)
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)$")


def sanitize_metric_name(name: str) -> str:
    """Map registry names (``onpolicy/frames_generated``) onto the
    Prometheus charset ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not out or not re.match(r"[a-zA-Z_:]", out[0]):
        out = "_" + out
    return out


def _fmt(v) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f.is_integer() and abs(f) < 2 ** 53:
        return str(int(f))              # exact ints: ledger counters must
    return repr(f)                      # round-trip exactly through a scrape


def render_prometheus(snapshot: dict,
                      extra_gauges: Optional[Dict[str, float]] = None) -> str:
    """Render a merged `MetricsRegistry.snapshot()` as Prometheus text.

    Histograms emit cumulative ``_bucket{le=...}`` samples (bucket i of a
    log2 histogram covers ``[v0*2^i, v0*2^(i+1))``, so its upper bound is
    ``v0*2^(i+1)``), ``_sum``/``_count``, and the registry's p50/p95/p99
    estimates as ``_p50``/``_p95``/``_p99`` gauges. Name collisions after
    sanitization keep the first family (deterministic: sorted order)."""
    lines: List[str] = []
    emitted = set()

    def family(name: str, ftype: str) -> bool:
        if name in emitted:
            return False
        emitted.add(name)
        lines.append(f"# TYPE {name} {ftype}")
        return True

    for raw, v in sorted(snapshot.get("counters", {}).items()):
        n = sanitize_metric_name(raw)
        if family(n, "counter"):
            lines.append(f"{n} {_fmt(v)}")
    gauges = dict(snapshot.get("gauges", {}))
    gauges.update(extra_gauges or {})
    for raw, v in sorted(gauges.items()):
        n = sanitize_metric_name(raw)
        if family(n, "gauge"):
            lines.append(f"{n} {_fmt(v)}")
    for raw, snap in sorted(snapshot.get("histograms", {}).items()):
        n = sanitize_metric_name(raw)
        if not family(n, "histogram"):
            continue
        v0 = snap["v0"]
        cum = 0
        for i in sorted(int(k) for k in snap.get("buckets", {})):
            cum += snap["buckets"][i]
            le = v0 * (2.0 ** (i + 1))
            lines.append(f'{n}_bucket{{le="{_fmt(le)}"}} {cum}')
        lines.append(f'{n}_bucket{{le="+Inf"}} {int(snap["count"])}')
        lines.append(f"{n}_sum {_fmt(snap['sum'])}")
        lines.append(f"{n}_count {int(snap['count'])}")
        for p in ("p50", "p95", "p99"):
            pn = f"{n}_{p}"
            val = snap.get(p)
            if family(pn, "gauge"):
                lines.append(
                    f"{pn} {_fmt(val) if val is not None else 'NaN'}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict:
    """Parse a text exposition into ``{"types": {family: type},
    "samples": [(name, labels, value)]}``. Strict enough to be the CI
    gate's round-trip check; raises ValueError on a malformed line."""
    types: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                if parts[2] in types:
                    raise ValueError(
                        f"line {lineno}: duplicate TYPE for {parts[2]}")
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: unparseable sample {line!r}")
        name, rawlabels, rawval = m.groups()
        labels = {}
        if rawlabels:
            try:
                labels = _parse_labels(rawlabels[1:-1])
            except ValueError as exc:
                raise ValueError(f"line {lineno}: {exc}") from None
        samples.append((name, labels, float(rawval)))
    return {"types": types, "samples": samples}


def _parse_labels(raw: str) -> Dict[str, str]:
    """Escape-aware label scanner: ``k1="v1",k2="v2"`` where values may
    contain commas, raw ``}``, and the exposition-format escapes ``\\\\``
    ``\\"`` ``\\n``. A naive split-on-comma silently mangles all three —
    this is a character scanner instead."""
    labels: Dict[str, str] = {}
    i, n = 0, len(raw)
    while i < n:
        if raw[i] in ", \t":
            i += 1
            continue
        eq = raw.find("=", i)
        if eq < 0:
            raise ValueError(f"label item without '=' in {raw!r}")
        key = raw[i:eq].strip()
        j = eq + 1
        if j < n and raw[j] == '"':
            j += 1
            out = []
            while j < n and raw[j] != '"':
                c = raw[j]
                if c == "\\" and j + 1 < n:
                    nxt = raw[j + 1]
                    out.append({"n": "\n", "\\": "\\", '"': '"'}
                               .get(nxt, "\\" + nxt))
                    j += 2
                    continue
                out.append(c)
                j += 1
            if j >= n:
                raise ValueError(f"unterminated label value in {raw!r}")
            labels[key] = "".join(out)
            i = j + 1                   # past the closing quote
        else:                           # lenient: historical unquoted form
            end = raw.find(",", j)
            end = n if end < 0 else end
            labels[key] = raw[j:end].strip().strip('"')
            i = end
    return labels


def value_of(parsed: dict, name: str) -> Optional[float]:
    """First sample value for `name` (no labels), or None."""
    for n, labels, v in parsed["samples"]:
        if n == name and not labels:
            return v
    return None


def validate_prometheus(text: str) -> List[str]:
    """Structural checks on an exposition; returns violation strings
    (empty = valid). Checks: parseability, name charset, every sample
    backed by a TYPE declaration, histogram bucket cumulative
    monotonicity, and ``+Inf`` bucket == ``_count``."""
    out: List[str] = []
    try:
        parsed = parse_prometheus(text)
    except ValueError as exc:
        return [str(exc)]
    types, samples = parsed["types"], parsed["samples"]

    def base_family(name: str) -> Optional[str]:
        if name in types:
            return name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in types:
                return name[:-len(suffix)]
        return None

    buckets: Dict[str, List[Tuple[float, float]]] = {}
    counts: Dict[str, float] = {}
    for name, labels, value in samples:
        if not _NAME_OK.match(name):
            out.append(f"bad metric name {name!r}")
            continue
        fam = base_family(name)
        if fam is None:
            out.append(f"sample {name!r} has no TYPE declaration")
            continue
        if types[fam] == "histogram":
            if name == fam + "_bucket":
                le = labels.get("le")
                if le is None:
                    out.append(f"{name}: bucket sample without le label")
                    continue
                buckets.setdefault(fam, []).append((float(le), value))
            elif name == fam + "_count":
                counts[fam] = value
    for fam, bs in buckets.items():
        les = [le for le, _ in bs]
        if les != sorted(les):
            out.append(f"{fam}: bucket le bounds not sorted")
        vals = [v for _, v in bs]
        if any(b < a for a, b in zip(vals, vals[1:])):
            out.append(f"{fam}: bucket counts not cumulative")
        if not les or les[-1] != float("inf"):
            out.append(f"{fam}: missing +Inf bucket")
        elif fam in counts and vals[-1] != counts[fam]:
            out.append(f"{fam}: +Inf bucket {vals[-1]} != _count "
                       f"{counts[fam]}")
    return out


def _jsonable(o):
    """Best-effort JSON coercion: numpy scalars/arrays -> Python, and
    anything else stringified — /varz must render whatever throughput()
    holds, never 500."""
    if isinstance(o, dict):
        return {str(k): _jsonable(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_jsonable(v) for v in o]
    if o is None or isinstance(o, (bool, int, float, str)):
        return o
    if callable(getattr(o, "item", None)):
        try:
            return _jsonable(o.item())
        except Exception:
            pass
    if callable(getattr(o, "tolist", None)):
        try:
            return _jsonable(o.tolist())
        except Exception:
            pass
    return str(o)


class _Handler(BaseHTTPRequestHandler):
    # one request = one short-lived thread (ThreadingHTTPServer)

    def log_message(self, fmt, *args):       # no stderr chatter per scrape
        pass

    def _send(self, code: int, body: str, ctype: str):
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 (http.server API)
        ops = self.server.ops
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                self._send(200, ops.render_metrics(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/healthz":
                report = ops.health_report()
                code = 200 if report.get("verdict") == "healthy" else 503
                self._send(code, json.dumps(report, default=str),
                           "application/json")
            elif path == "/varz":
                self._send(200, json.dumps(_jsonable(ops.varz()),
                                           default=str),
                           "application/json")
            elif path == "/trace":
                self._send(200,
                           json.dumps(chrome_trace(
                               ops.telemetry.trace_events())),
                           "application/json")
            elif path == "/autoscaler":
                doc = ops.autoscaler()
                if doc is None:
                    self._send(404, json.dumps(
                        {"error": "no autoscaler registered",
                         "hint": "SeedSystem(autoscale=AutoscaleConfig())"
                         }), "application/json")
                else:
                    self._send(200, json.dumps(_jsonable(doc),
                                               default=str),
                               "application/json")
            elif path == "/timeseries":
                window = 120.0
                q = self.path.split("?", 1)
                if len(q) == 2:
                    for item in q[1].split("&"):
                        k, _, v = item.partition("=")
                        if k == "window":
                            try:
                                window = float(v)
                            except ValueError:
                                pass
                doc = ops.timeseries(window)
                if doc is None:
                    self._send(404, json.dumps(
                        {"error": "no time-series store registered"}),
                        "application/json")
                else:
                    self._send(200, json.dumps(_jsonable(doc),
                                               default=str),
                               "application/json")
            else:
                self._send(404, json.dumps({"error": "not found",
                                            "endpoints": ["/metrics",
                                                          "/healthz",
                                                          "/varz",
                                                          "/trace",
                                                          "/autoscaler",
                                                          "/timeseries"]}),
                           "application/json")
        except Exception as exc:             # an exporter bug must not wedge
            try:                             # the scraper's connection
                self._send(500, json.dumps({"error": repr(exc)}),
                           "application/json")
            except Exception:
                pass


class OpsServer:
    """One HTTP thread exporting a `Telemetry` bundle; see module doc.

    `add_collector(fn)` registers a per-scrape gauge source
    (``fn() -> {name: value}``); `set_varz(fn)` installs the /varz
    document provider (SeedSystem wires its `throughput()`)."""

    def __init__(self, telemetry, host: str = "127.0.0.1", port: int = 0):
        self.telemetry = telemetry
        self.host = host
        self.port = port
        self.address: Optional[Tuple[str, int]] = None
        self.scrapes = 0                 # /metrics hits, for the tests
        self._collectors: List[Callable[[], Dict[str, float]]] = []
        self._varz_fn: Optional[Callable[[], dict]] = None
        self._autoscaler_fn: Optional[Callable[[], dict]] = None
        self._timeseries_fn: Optional[Callable[..., dict]] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def add_collector(self, fn: Callable[[], Dict[str, float]]):
        self._collectors.append(fn)

    def set_varz(self, fn: Callable[[], dict]):
        self._varz_fn = fn

    def set_autoscaler(self, fn: Callable[[], dict]):
        """Install the /autoscaler document provider (the controller's
        `dump`: decision log + topology + bounds)."""
        self._autoscaler_fn = fn

    def set_timeseries(self, fn: Callable[..., dict]):
        """Install the /timeseries provider: ``fn(window_s)`` returning a
        `TimeSeriesStore.dump()`-shaped document."""
        self._timeseries_fn = fn

    # ----------------------------------------------------- endpoint bodies

    def render_metrics(self) -> str:
        self.scrapes += 1
        extra: Dict[str, float] = {}
        for fn in self._collectors:
            try:
                extra.update(fn())
            except Exception:
                pass                     # a dead collector must not 500 /metrics
        return render_prometheus(self.telemetry.merged_snapshot(),
                                 extra_gauges=extra)

    def autoscaler(self) -> Optional[dict]:
        if self._autoscaler_fn is None:
            return None
        return self._autoscaler_fn()

    def timeseries(self, window_s: float = 120.0) -> Optional[dict]:
        if self._timeseries_fn is None:
            return None
        return self._timeseries_fn(window_s)

    def health_report(self) -> dict:
        health = getattr(self.telemetry, "health", None)
        if health is None:
            return {"verdict": "healthy", "components": {}, "events": []}
        return health.report().as_dict()

    def varz(self) -> dict:
        if self._varz_fn is not None:
            return self._varz_fn()
        out = {"health": self.health_report()}
        flightrec = getattr(self.telemetry, "flightrec", None)
        if flightrec is not None:
            out["postmortems"] = list(flightrec.bundles)
        try:
            out["bottleneck"] = self.telemetry.bottleneck_report({}).as_dict()
        except Exception:
            pass
        return out

    # ----------------------------------------------------------- lifecycle

    def start(self) -> Tuple[str, int]:
        if self._httpd is not None:
            return self.address
        httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        httpd.daemon_threads = True
        httpd.ops = self
        self._httpd = httpd
        self.address = httpd.server_address[:2]
        self._thread = threading.Thread(target=httpd.serve_forever,
                                        kwargs={"poll_interval": 0.1},
                                        name="telemetry-ops", daemon=True)
        self._thread.start()
        return self.address

    def stop(self):
        httpd, self._httpd = self._httpd, None
        t, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if t is not None:
            t.join(timeout=5.0)
