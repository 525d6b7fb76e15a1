"""K1: causal flash attention (prefill) — the CUDA kernels' Python wrapper.

Replaces ``repro.kernels.flash_attention.flash_attention`` (Pallas, TPU).
The kernels are in ``csrc/flash_attention.cu``; its plain PyTorch version
is ``ref.attention_ref``, which ``ops.flash_attention`` takes for CPU
tensors. The ``.cu`` picks one of two routes by dtype and head_dim alone
(``route``): bf16 at D 64, 128 and 256 runs on the tensor cores (wgmma),
everything else on the fp32 CUDA cores. ``flash_attention.launches``
counts every launch, ``flash_attention.launches_by_route`` each route's.
"""

import ctypes
import functools

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128, 256)
ROUTES = ("wgmma", "cuda_cores")


def route(dtype, head_dim) -> str:
    """The kernel a launch takes: "wgmma" for bf16 at D 64, 128 or 256,
    "cuda_cores" otherwise (fp32 on the tensor cores would be TF32)."""
    return "wgmma" if dtype == torch.bfloat16 and head_dim in (64, 128, 256) else "cuda_cores"


@functools.cache
def _fn():
    """The C entry point, built, loaded and typed once per process."""
    fn = build.load("flash_attention").flash_attention
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_route(dtype, head_dim) -> str:
    """The route the built library itself picks for (dtype, head_dim)."""
    fn = build.load("flash_attention").flash_attention_route
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return ROUTES[0] if fn(DTYPES[dtype], head_dim) else ROUTES[1]


def flash_attention(q, k, v, *, scale=None, causal=True, window=0, softcap=None):
    """q (B,S,H,D); k,v (B,S,KH,D) with KH dividing H (KH == H is the
    head-expanded layout). Contiguous CUDA tensors of one dtype. Returns
    (B,S,H,D) in q's dtype. Launches on the current stream, no sync."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"want q (B,S,H,D), k = v (B,S,KH,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    kh = k.shape[2]
    if k.shape[:2] != (b, s) or k.shape[3] != d or h % kh:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(DTYPES)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention kernel needs q, k, v on one CUDA device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    fn = _fn()
    with torch.cuda.device(q.device):
        err = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, s, h, kh, d, float(scale), int(bool(causal)),
                 int(window or 0), float(softcap or 0.0),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.launches_by_route[route(q.dtype, d)] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
