"""K4: the RG-LRU linear recurrence — the CUDA kernel's Python wrapper.

Replaces ``repro.kernels.rglru_scan.rglru_scan`` (Pallas, TPU). The kernel
is ``csrc/rglru_scan.cu``, a chunked scan over S: a CTA a strip of lanes of
one batch row, walking S in tiles of chunks (``plan`` reads the plan from
the built kernel). Its plain PyTorch version is ``ops.rglru_scan_plain``,
which ``ops.rglru_scan`` takes for CPU tensors.
"""

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPES

# what rglru_scan_plan writes, in its order
PLAN_KEYS = ("lw", "t", "nc", "tiles", "ctas", "ctas_per_sm")


def entry(lib):
    """The C entry point rglru_scan of `lib` (a built csrc/rglru_scan.cu,
    loaded by ctypes), typed."""
    fn = lib.rglru_scan
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fn():
    """The shipped kernel's entry point, built, loaded and typed once per
    process."""
    return entry(build.load("rglru_scan"))


def launch(fn, a, b, h0, y, h_last):
    """Launch `fn` (an entry point typed by ``entry``) into the given y and
    h_last, on the current stream of a's device; raises on a CUDA error."""
    bsz, s, w = a.shape
    with torch.cuda.device(a.device):
        err = fn(DTYPES[y.dtype], a.data_ptr(), b.data_ptr(),
                 None if h0 is None else h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                 bsz, s, w, torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err}")


def plan(b, s, w, lib=None) -> dict:
    """The plan of a launch at (B, S, W), from the built kernel (or from
    `lib`, another build of csrc/rglru_scan.cu): lanes a strip (lw), steps
    a chunk (t), chunks a tile (nc), tiles of S, CTAs, and the CTAs an SM
    holds by the CUDA occupancy calculator."""
    fn = (lib or build.load("rglru_scan")).rglru_scan_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(PLAN_KEYS))()
    err = fn(b, s, w, out)
    if err:
        raise RuntimeError(f"rglru_scan_plan failed: CUDA error {err}")
    return dict(zip(PLAN_KEYS, out))


def rglru_scan(a, b, *, h0=None, out_dtype=torch.float32):
    """a, b (B,S,W) fp32; h0 (B,W) fp32 or None (zeros). Contiguous CUDA
    tensors on one device. Returns (y (B,S,W) in `out_dtype`, h_last (B,W)
    fp32). Launches on the current stream, no sync."""
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"want a = b (B,S,W); got {tuple(a.shape)}, {tuple(b.shape)}")
    bsz, s, w = a.shape
    if h0 is not None and h0.shape != (bsz, w):
        raise ValueError(f"h0 {tuple(h0.shape)} does not match a {tuple(a.shape)}")
    ins = (a, b) + (() if h0 is None else (h0,))
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"a, b and h0 must be fp32; got {[t.dtype for t in ins]}")
    if out_dtype not in DTYPES:
        raise TypeError(f"out_dtype must be one of {list(DTYPES)}; got {out_dtype}")
    if not (a.is_cuda and all(t.device == a.device for t in ins)):
        raise ValueError("rglru_scan kernel needs every input on one CUDA device")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("rglru_scan kernel needs contiguous inputs")
    if min(a.shape) == 0:
        raise ValueError(f"empty input {tuple(a.shape)}")
    y = torch.empty(a.shape, dtype=out_dtype, device=a.device)
    h_last = torch.empty((bsz, w), dtype=torch.float32, device=a.device)
    launch(_fn(), a, b, h0, y, h_last)
    rglru_scan.launches += 1
    return y, h_last


rglru_scan.launches = 0
