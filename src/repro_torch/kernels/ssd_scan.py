"""K3: the Mamba2 SSD chunked scan — the CUDA kernel's Python wrapper.

Replaces ``repro.kernels.ssd_scan.ssd_scan`` (Pallas, TPU). The kernels
are in ``csrc/ssd_scan.cu``; its plain PyTorch version is
``ops.ssd_scan_plain``, which ``ops.ssd_scan`` takes for CPU tensors. The
``.cu`` picks one of two routes by dtype, P and N alone (``route``): bf16
with P a multiple of 64 and N 64 or 128, which the serving path calls,
runs the chunk's products on the tensor cores (wgmma), everything else on
the fp32 CUDA cores. ``ssd_scan.launches`` counts every launch,
``ssd_scan.launches_by_route`` each route's.
"""

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPES

MAX_STATE = 128   # largest N (NMAX in the source)
ROUTES = ("wgmma", "cuda_cores")


def route(dtype, p, n) -> str:
    """The kernel a launch takes: "wgmma" for bf16 with P a multiple of 64
    and N 64 or 128, "cuda_cores" otherwise (fp32 on the tensor cores would
    be TF32)."""
    return ("wgmma" if dtype == torch.bfloat16 and p % 64 == 0 and n in (64, 128)
            else "cuda_cores")


@functools.cache
def _fn():
    """The C entry point, built, loaded and typed once per process."""
    fn = build.load("ssd_scan").ssd_scan
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan(b, h, p) -> tuple:
    """(heads a CTA, CTAs) of a launch: on either route one CTA per (64
    columns p, head, batch); the tensor-core route's CTA is two warpgroups,
    the CUDA-core route's 256 threads."""
    return 1, b * h * -(-p // 64)


def kernel_route(dtype, p, n) -> str:
    """The route the built library itself picks for (dtype, P, N)."""
    fn = build.load("ssd_scan").ssd_scan_route
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    return ROUTES[0] if fn(DTYPES[dtype], p, n) else ROUTES[1]


def ssd_scan(x, dt, a, b, c, *, h0=None, return_state=False):
    """x (B,S,H,P) fp32 or bf16; dt (B,S,H) fp32; a (H,) fp32; b, c (B,S,G,N)
    in x's dtype, G dividing H, N <= 128; h0 (B,H,P,N) fp32 or None.
    Contiguous CUDA tensors on one device. Returns (y in x's dtype, final
    state (B,H,P,N) fp32, or None unless `return_state`). Launches on the
    current stream, no sync."""
    if x.dim() != 4 or b.dim() != 4 or b.shape != c.shape:
        raise ValueError(f"want x (B,S,H,P), b = c (B,S,G,N); got {tuple(x.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if b.shape[:2] != (bsz, s) or h % g or dt.shape != (bsz, s, h) or a.shape != (h,):
        raise ValueError(f"dt {tuple(dt.shape)}, a {tuple(a.shape)}, b/c {tuple(b.shape)} "
                         f"do not match x {tuple(x.shape)}")
    if n > MAX_STATE:
        raise ValueError(f"state size {n} > {MAX_STATE}")
    if h0 is not None and (h0.shape != (bsz, h, p, n) or h0.dtype != torch.float32):
        raise ValueError(f"h0 must be fp32 of shape {(bsz, h, p, n)}")
    if x.dtype not in DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b, c must share one of {list(DTYPES)}; got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"dt and a must be fp32; got {dt.dtype}, {a.dtype}")
    ins = (x, dt, a, b, c) + (() if h0 is None else (h0,))
    if not (x.is_cuda and all(t.device == x.device for t in ins)):
        raise ValueError("ssd_scan kernel needs every input on one CUDA device")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("ssd_scan kernel needs contiguous inputs")
    path = route(x.dtype, p, n)
    if path == "wgmma" and any(t.data_ptr() % 16 for t in (x, b, c)):
        raise ValueError("ssd_scan's tensor-core route needs x, b, c 16-byte aligned")
    y = torch.empty_like(x)
    state = (torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if return_state else None)
    fn = _fn()
    with torch.cuda.device(x.device):
        err = fn(DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                 c.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
                 None if state is None else state.data_ptr(), bsz, s, h, p, g, n,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    ssd_scan.launches_by_route[path] += 1
    return y, state


ssd_scan.launches = 0
ssd_scan.launches_by_route = dict.fromkeys(ROUTES, 0)
