"""K4: the RG-LRU linear recurrence — the CUDA kernel's Python wrapper.

Replaces ``repro.kernels.rglru_scan.rglru_scan`` (Pallas, TPU). The kernel
is ``csrc/rglru_scan.cu``, a chunked scan over S: a CTA a strip of lanes of
one batch row, walking S in tiles of chunks (``plan`` reads the plan from
the built kernel). Its plain PyTorch version is ``ops.rglru_scan_plain``,
which ``ops.rglru_scan`` takes for CPU tensors.

The gradient (K4-bwd) is ``csrc/rglru_scan_bwd.cu``, K4's chunked scan run
in reverse (``bwd_plan`` reads its plan), which reads the forward's h in
fp32. ``RGLRUScan`` is the autograd Function that pairs the two: it asks
the forward for an fp32 y whatever the output dtype, keeps it, and casts
the output.
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


def _plan(fn, b, s, w) -> dict:
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(PLAN_KEYS))()
    err = fn(b, s, w, out)
    if err:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")
    return dict(zip(PLAN_KEYS, out))


def plan(b, s, w, lib=None) -> dict:
    """The plan of a launch at (B, S, W), from the built kernel (or from
    `lib`, another build of csrc/rglru_scan.cu): lanes a strip (lw), steps
    a chunk (t), chunks a tile (nc), tiles of S, CTAs, and the CTAs an SM
    holds by the CUDA occupancy calculator."""
    return _plan((lib or build.load("rglru_scan")).rglru_scan_plan, b, s, w)


def bwd_plan(b, s, w) -> dict:
    """The plan of a K4-bwd launch at (B, S, W), from the built kernel, with
    the keys of ``plan``."""
    return _plan(build.load("rglru_scan_bwd").rglru_scan_bwd_plan, b, s, w)


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


@functools.cache
def _bwd_fn():
    """The backward's C entry point, built, loaded and typed once per process."""
    fn = build.load("rglru_scan_bwd").rglru_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rglru_scan_bwd(a, y, h0, dy, dh_last):
    """K4-bwd: (da, db, dh0) of ``rglru_scan`` given a, its fp32 output y
    (the h sequence), h0 (or None: zeros), and the gradients dy (B,S,W) and
    dh_last (B,W) (or None: zeros). All fp32, contiguous, on one CUDA
    device. dh0 is None when h0 is. Launches on the current stream, no
    sync."""
    if a.dim() != 3 or y.shape != a.shape or dy.shape != a.shape:
        raise ValueError(f"want a = y = dy (B,S,W); got {tuple(a.shape)}, {tuple(y.shape)}, "
                         f"{tuple(dy.shape)}")
    bsz, s, w = a.shape
    ins = (a, y, dy) + tuple(t for t in (h0, dh_last) if t is not None)
    if any(t.shape != (bsz, w) for t in (h0, dh_last) if t is not None):
        raise ValueError(f"h0 and dh_last must be (B,W) = {(bsz, w)}")
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"rglru_scan_bwd is fp32 only; got {[t.dtype for t in ins]}")
    if not (a.is_cuda and all(t.device == a.device for t in ins)):
        raise ValueError("rglru_scan_bwd kernel needs every input on one CUDA device")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("rglru_scan_bwd kernel needs contiguous inputs")
    if min(a.shape) == 0:
        raise ValueError(f"empty input {tuple(a.shape)}")
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    with torch.cuda.device(a.device):
        err = _bwd_fn()(a.data_ptr(), y.data_ptr(), ptr(h0), dy.data_ptr(), ptr(dh_last),
                        da.data_ptr(), db.data_ptr(), ptr(dh0), bsz, s, w,
                        torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan_bwd launch failed: CUDA error {err}")
    rglru_scan_bwd.launches += 1
    return da, db, dh0


rglru_scan_bwd.launches = 0


class RGLRUScan(torch.autograd.Function):
    """K4 with K4-bwd as its gradient. The forward keeps its fp32 h sequence
    (the backward's h_{t-1}) and returns it cast to `out_dtype`."""

    @staticmethod
    def forward(ctx, a, b, h0, out_dtype):
        y, h_last = rglru_scan(a, b, h0=h0, out_dtype=torch.float32)
        ctx.save_for_backward(a, y, h0)
        return y.to(out_dtype), h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        a, y, h0 = ctx.saved_tensors
        dy = torch.zeros_like(y) if dy is None else dy.float().contiguous()
        dh_last = None if dh_last is None else dh_last.contiguous()
        da, db, dh0 = rglru_scan_bwd(a, y, h0, dy, dh_last)
        return da, db, dh0, None
