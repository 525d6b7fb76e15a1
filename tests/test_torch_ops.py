"""The port's live ops plane on the CPU, held to the JAX package's.

`repro_torch.telemetry.ops` is a copy of ``repro.telemetry.ops``: the same
registry contents must render to the same Prometheus text byte for byte,
the parser and the validator must give the same answers on the same text
(broken expositions included), and an `OpsServer` over either package's
bundle must answer every route with the same status and body. The live
test runs a V-trace `SeedSystem` in process with ``ops_port=0`` and holds
its /metrics ledger to `throughput()` exactly, never to a rate.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.telemetry import MetricsRegistry as JMetricsRegistry  # noqa: E402
from repro.telemetry import Telemetry as JTelemetry  # noqa: E402
from repro.telemetry import ops as jops  # noqa: E402
from repro_torch.core.system import SeedSystem  # noqa: E402
from repro_torch.envs.catch import CatchEnv  # noqa: E402
from repro_torch.onpolicy import VTraceLearner, mlp_actor_critic  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.telemetry import MetricsRegistry, Telemetry  # noqa: E402
from repro_torch.telemetry import ops  # noqa: E402
from repro_torch.telemetry.ops import OpsServer  # noqa: E402

torch.set_num_threads(1)


def _http_get(url, timeout=5.0):
    """(status, content type, body): a 503 /healthz still has a body."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def _canon(parsed):
    """A parsed exposition with NaN values (an empty histogram's
    quantiles) spelled as a string, so that == compares them."""
    return {"types": parsed["types"],
            "samples": [(n, lab, "nan" if v != v else v) for n, lab, v in parsed["samples"]]}


def _fill(reg, seed):
    """The same counters, gauges and histograms in either package's
    registry, drawn from `seed`: ledger ints past 2^31, a float counter,
    gauges with a callback, latencies over many decades."""
    rng = np.random.default_rng(seed)
    reg.counter("onpolicy/frames_generated").add(int(rng.integers(2 ** 31, 2 ** 40)))
    reg.counter("inference/r0/compute_s").add(float(rng.random()))
    reg.counter("9lives").add(3)
    reg.gauge("onpolicy/frames_pending").set(int(rng.integers(0, 100)))
    reg.gauge("inference/active_replicas", fn=lambda: 2)
    for name in ("learner/train_s", "wire/rtt_s"):
        h = reg.histogram(name)
        for v in 10.0 ** rng.uniform(-7, 1, int(rng.integers(1, 40))):
            h.record(float(v))
    reg.histogram("empty/never_recorded")
    return reg


@pytest.mark.parametrize("seed", range(4))
def test_render_prometheus_byte_identical_to_reference(seed):
    extra = {"inference/num_slots": 4 + seed, "recovery/host_restarts": seed}
    got = ops.render_prometheus(_fill(MetricsRegistry(), seed).snapshot(), extra_gauges=extra)
    want = jops.render_prometheus(_fill(JMetricsRegistry(), seed).snapshot(),
                                  extra_gauges=extra)
    assert got == want
    assert ops.validate_prometheus(got) == [] == jops.validate_prometheus(want)
    assert _canon(ops.parse_prometheus(got)) == _canon(jops.parse_prometheus(want))
    assert ops.value_of(ops.parse_prometheus(got), "inference_num_slots") == 4 + seed


BROKEN = {
    "garbage": "totally not prometheus{",
    "untyped": "orphan 1\n",
    "non_monotone": ('# TYPE h histogram\nh_bucket{le="1"} 5\nh_bucket{le="2"} 3\n'
                     'h_bucket{le="+Inf"} 5\nh_sum 1\nh_count 5\n'),
    "inf_ne_count": '# TYPE h histogram\nh_bucket{le="+Inf"} 4\nh_sum 1\nh_count 5\n',
    "label_escapes": ('# TYPE x gauge\nx{a="q\\"uote",b="back\\\\slash",c="new\\nline"} 2\n'),
    "bad_value": "# TYPE y counter\ny one\n",
    "empty": "",
}


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_parse_and_validate_as_the_reference(name):
    text = BROKEN[name]
    assert ops.validate_prometheus(text) == jops.validate_prometheus(text)
    try:
        want = jops.parse_prometheus(text)
    except Exception as e:                  # noqa: BLE001 — the port must raise alike
        with pytest.raises(type(e)):
            ops.parse_prometheus(text)
        return
    assert _canon(ops.parse_prometheus(text)) == _canon(want)


def test_sanitize_metric_name_as_the_reference():
    for name in ("onpolicy/frames_generated", "inference/r0/batches", "9lives", "ok_name:x",
                 "a-b.c d", "", "cpu/actor-host-3_cores"):
        assert ops.sanitize_metric_name(name) == jops.sanitize_metric_name(name)


def _bundle(cls_tel, cls_ops, seed):
    tel = cls_tel(process_name="learner", out_dir="unused")
    _fill(tel.metrics, seed)
    tel.health.register("loop", stale_after_s=60.0)
    tel.health.beat("loop")
    server = cls_ops(tel)
    server.add_collector(lambda: {"inference/num_slots": 8})
    return tel, server


def test_ops_server_routes_as_the_reference():
    """Every route of the port's server against the reference's, each over
    its own package's bundle filled alike: statuses and content types
    equal, /metrics byte for byte, /healthz's verdict, /varz's keys, 404s
    for the absent autoscaler and time series and for unknown paths."""
    tel, got = _bundle(Telemetry, OpsServer, 1)
    _, want = _bundle(JTelemetry, jops.OpsServer, 1)
    try:
        base = {"got": "http://%s:%d" % got.start(), "want": "http://%s:%d" % want.start()}
        for route in ("/metrics", "/healthz", "/varz", "/trace", "/autoscaler",
                      "/timeseries?window=5", "/nope"):
            g = _http_get(base["got"] + route)
            w = _http_get(base["want"] + route)
            assert g[:2] == w[:2], route
            if route == "/metrics":
                assert g[2] == w[2]
            elif route in ("/autoscaler", "/timeseries?window=5", "/nope"):
                assert g[0] == 404 and json.loads(g[2]) == json.loads(w[2])
            else:
                assert sorted(json.loads(g[2])) == sorted(json.loads(w[2])), route
        assert json.loads(_http_get(base["got"] + "/healthz")[2])["verdict"] == "healthy"
        got.set_timeseries(lambda w: {"window_s": w, "series": {}})
        got.set_autoscaler(lambda: {"enabled": True})
        assert json.loads(_http_get(base["got"] + "/timeseries?window=7")[2])["window_s"] == 7.0
        assert _http_get(base["got"] + "/autoscaler")[0] == 200
        tel.health.event("auditor", "ledger not conserved")
        code, _, body = _http_get(base["got"] + "/healthz")
        assert code == 503 and json.loads(body)["verdict"] == "degraded"
        assert got.scrapes == 1
    finally:
        got.stop()
        want.stop()


def test_live_metrics_ledger_equals_throughput_and_audit_is_clean(tmp_path):
    """A V-trace system in process (the MLP learner on the CPU) with the
    ops plane: after the run, one /metrics scrape holds the conserved
    ledger equal to `throughput()["onpolicy"]` exactly, the Prometheus
    text validates, /varz carries the schema, the stats and the
    bottleneck, and the continuous auditor found nothing."""
    obs_dim = 50
    init_fn, apply_fn = mlp_actor_critic(obs_dim, CatchEnv.num_actions)
    vl = VTraceLearner(apply_fn, adamw(1e-3))
    params = init_fn(torch.Generator().manual_seed(0), "cpu")
    state = vl.init_state(params)
    policy = vl.sampling_policy(params)
    tel = Telemetry(process_name="learner", out_dir=str(tmp_path))
    system = SeedSystem(env_factory=lambda: CatchEnv(device="cpu"), policy_step=policy,
                        num_actors=2, unroll=8, envs_per_actor=4, deadline_ms=1.0,
                        algo="vtrace", train_step=vl.train_step, state=state, learner_batch=4,
                        max_param_lag=50, policy_publish=policy.publish, telemetry=tel,
                        ops_port=0)
    system.warmup()
    base = "http://%s:%d" % system.ops_address
    try:
        stats = system.run(seconds=1.0)
        assert stats["learner_error"] is None and stats["learner_steps"] > 0
        assert stats["ops_address"] == "%s:%d" % system.ops_address
        code, ctype, text = _http_get(base + "/metrics")
        assert code == 200 and ctype.startswith("text/plain; version=0.0.4")
        assert ops.validate_prometheus(text) == []
        parsed = ops.parse_prometheus(text)
        onp = stats["onpolicy"]
        for k in ("frames_generated", "frames_trained", "frames_dropped", "frames_pending"):
            assert ops.value_of(parsed, f"onpolicy_{k}") == onp[k], k
        assert onp["frames_generated"] == onp["frames_trained"] + onp["frames_dropped"]
        assert ops.value_of(parsed, "inference_num_slots") == system.server.num_slots
        varz = json.loads(_http_get(base + "/varz")[2])
        assert varz["schema_version"] == 2
        assert varz["stats"]["onpolicy"]["frames_generated"] == onp["frames_generated"]
        assert varz["bottleneck"]["bottleneck"] in ("actor-bound", "inference-bound",
                                                    "learner-bound", "wire-bound", "idle")
        assert tel.auditor.violations == []
        assert sorted(tel.auditor._checks) == ["frame_ledger", "slot_table"]
    finally:
        system.stop_ops()
    assert system.ops_address is None
