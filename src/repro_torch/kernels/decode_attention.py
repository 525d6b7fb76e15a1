"""K2: decode attention — the CUDA kernel's Python wrapper.

Replaces ``repro.kernels.decode_attention.decode_attention`` (Pallas, TPU).
The kernel is ``csrc/decode_attention.cu``; its plain PyTorch version is
``ref.decode_attention_ref``, which ``ops.decode_attention`` takes for CPU
tensors.
"""

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS


@functools.cache
def _fn():
    """The C entry point, built, loaded and typed once per process."""
    fn = build.load("decode_attention").decode_attention
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q, k, v, lengths, *, scale=None):
    """q (B,H,D); k,v (B,S,KH,D) with KH dividing H; lengths (B,) int32.
    Contiguous CUDA tensors, q/k/v of one dtype. Returns (B,H,D) in q's
    dtype. Launches on the current stream, no sync."""
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,H,D), k = v (B,S,KH,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kh:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32 of shape ({b},)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(DTYPES)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_cuda and all(t.device == q.device for t in (k, v, lengths))):
        raise ValueError("decode_attention kernel needs every input on one CUDA device")
    if not all(t.is_contiguous() for t in (q, k, v, lengths)):
        raise ValueError("decode_attention kernel needs contiguous inputs")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    fn = _fn()
    with torch.cuda.device(q.device):
        err = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), b, s, h, kh, d, float(scale),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
