"""Builds the port's CUDA kernels from ``csrc/`` and loads them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), under
``build/kernels/`` at the root of the checkout. The library's file name
carries a hash of its source, of every ``csrc/*.cuh`` header the source
includes (directly or through another header), and of the flags, so an
edited source or header is rebuilt and a stale library is never loaded.
Building happens at first use, never at import: the CPU tests import
every module on a machine with no ``nvcc``.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("flash_attention", "decode_attention", "ssd_scan", "rglru_scan",
           "flash_attention_bwd", "ssd_scan_bwd", "rglru_scan_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+\.cuh)"[^\n]*$', re.M)   # a csrc/*.cuh

_lock = threading.Lock()
_libs = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return str(path)


def headers(name: str) -> list:
    """The csrc/*.cuh headers that csrc/<name>.cu includes, directly or
    through another header, sorted."""
    found, todo = set(), [CSRC / f"{name}.cu"]
    while todo:
        for inc in INCLUDE.findall(todo.pop().read_text()):
            if CSRC / inc not in found:
                found.add(CSRC / inc)
                todo.append(CSRC / inc)
    return sorted(found)


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *headers(name)):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def compile_sources(jobs: dict) -> dict:
    """Compile each (source .cu, library path) of `jobs`, one nvcc each, all
    started together; a library is moved into place only once it is built.
    Returns {key: ptxas report}; raises with the compiler's output if any
    build fails."""
    procs = {}
    for key, (src, out) in jobs.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    reports, failed = {}, []
    for key, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{key}:\n{log}")
            continue
        os.replace(tmp, out)
        reports[key] = log
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def build(names=KERNELS) -> dict:
    """Compile every missing library of `names` (``compile_sources``).
    Returns {name: ptxas report} for what was compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return compile_sources({name: (CSRC / f"{name}.cu", library_path(name))
                            for name in names if not library_path(name).exists()})


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
