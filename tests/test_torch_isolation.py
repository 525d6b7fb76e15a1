"""The port, and the chip smoke script that drives it, import torch and
never jax, and nothing of the JAX package."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PKG = SRC / "repro_torch"


def _modules():
    names = ["repro_torch"]
    for info in pkgutil.walk_packages([str(PKG)], prefix="repro_torch."):
        names.append(info.name)
    return names


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert {"repro_torch.kernels.ops", "repro_torch.launch.serve_policy",
            "repro_torch.core.inference", "repro_torch.convert",
            "repro_torch.kernels.ssd_scan", "repro_torch.nn.ssd", "repro_torch.nn.conv",
            "repro_torch.models.mamba", "repro_torch.configs.mamba2_2_7b",
            "repro_torch.kernels.rglru_scan", "repro_torch.nn.rglru",
            "repro_torch.models.recurrentgemma",
            "repro_torch.configs.recurrentgemma_2b", "repro_torch.launch.train",
            "repro_torch.core.losses", "repro_torch.core.vtrace", "repro_torch.optim.adamw",
            "repro_torch.checkpoint.ckpt", "repro_torch.fault.supervisor",
            "repro_torch.data.pipeline", "repro_torch.configs.r2d2_atari",
            "repro_torch.nn.recurrent", "repro_torch.models.atari", "repro_torch.core.r2d2",
            "repro_torch.core.replay", "repro_torch.telemetry.tracer",
            "repro_torch.envs.alesim", "repro_torch.envs.vector", "repro_torch.core.actor",
            "repro_torch.core.learner", "repro_torch.core.system",
            "repro_torch.launch.train_r2d2", "repro_torch.onpolicy",
            "repro_torch.onpolicy.queue", "repro_torch.onpolicy.batcher",
            "repro_torch.onpolicy.learner", "repro_torch.envs.catch",
            "repro_torch.launch.train_vtrace", "repro_torch.envs.cartpole",
            "repro_torch.envs.tokenworld", "repro_torch.rollout", "repro_torch.rollout.engine",
            "repro_torch.rollout.worker", "repro_torch.launch.rollout_backends",
            "repro_torch.transport", "repro_torch.transport.codec",
            "repro_torch.transport.local", "repro_torch.transport.shm",
            "repro_torch.transport.socket", "repro_torch.launch.actor_host",
            "repro_torch.fault", "repro_torch.fault.backoff", "repro_torch.hw",
            "repro_torch.core.provisioning", "repro_torch.core.bottleneck",
            "repro_torch.configs.shapes", "repro_torch.benchmarks",
            "repro_torch.benchmarks.fig2_breakdown", "repro_torch.benchmarks.fig3_actor_scaling",
            "repro_torch.benchmarks.fig4_cpu_gpu_ratio", "repro_torch.benchmarks.run",
            "repro_torch.launch.provision_system"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.') or m == 'triton')\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr


def test_no_source_names_jax_or_repro():
    """Static check over every source file and ``chip_smoke.py``, including
    code behind a function-level import that the subprocess test does not
    reach."""
    bad = []
    paths = [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]
    assert len(paths) > 30 and paths[-1].is_file()
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                if root in ("jax", "jaxlib", "repro", "flax", "optax"):
                    bad.append(f"{path.relative_to(ROOT)}: {n}")
    assert not bad, bad


def test_chip_smoke_without_a_card_fails_and_prints_no_result():
    """Where torch has no CUDA, the chip smoke script exits non-zero before
    it imports anything of the port, and prints no result line."""
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 2, res.stderr
    assert res.stdout == "" and "torch.cuda.is_available() is False" in res.stderr
