"""The port's bench trend guard (``repro_torch.benchmarks.check_trend``)
against the JAX package's ``benchmarks/check_trend.py``, loaded by path: the
same lines and exit codes on the same ``BENCH_history.json`` ledgers."""

import importlib.util
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.benchmarks import check_trend  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _reference():
    spec = importlib.util.spec_from_file_location("ref_check_trend",
                                                  ROOT / "benchmarks" / "check_trend.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _entries(*fps):
    return [{"commit": f"c{i}", "ts": i, "frames_per_s": f} for i, f in enumerate(fps)]


LEDGERS = {
    "no_file": None,
    "one_point": {"fig3_telemetry": _entries(100.0)},
    "regression": {"fig3_telemetry": _entries(100.0, 120.0, 80.0),
                   "fig4_socket": _entries(50.0, 49.0)},
    "pass": {"fig3_telemetry": _entries(100.0, 120.0, 95.0), "note": "not a series"},
}


@pytest.mark.parametrize("case", list(LEDGERS))
def test_same_lines_and_exit_codes_as_the_reference(case, tmp_path, capsys):
    path = tmp_path / "BENCH_history.json"
    if LEDGERS[case] is not None:
        path.write_text(json.dumps(LEDGERS[case]))
    runs = []
    for mod in (check_trend, _reference()):
        rc = mod.main([str(path), "--tolerance", "0.25"])
        runs.append((rc, capsys.readouterr().out))
    assert runs[0] == runs[1]
    want_rc = {"no_file": 0, "one_point": 0, "regression": 1, "pass": 0}[case]
    assert runs[0][0] == want_rc, runs[0][1]
    if case == "regression":
        assert "trend_FAIL,1,fig3_telemetry: latest 80.0" in runs[0][1]


def test_default_path_is_the_ports_ledger():
    assert Path(check_trend.DEFAULT_PATH) == ROOT / "build" / "bench_torch" / "BENCH_history.json"
