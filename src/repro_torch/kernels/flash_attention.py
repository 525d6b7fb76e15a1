"""K1: causal flash attention (prefill) — the CUDA kernels' Python wrapper.

Replaces ``repro.kernels.flash_attention.flash_attention`` (Pallas, TPU).
The kernels are in ``csrc/flash_attention.cu``; its plain PyTorch version
is ``ref.attention_ref``, which ``ops.flash_attention`` takes for CPU
tensors. The ``.cu`` picks one of two routes by dtype and head_dim alone
(``route``), both on the tensor cores: bf16 at D 64, 128 and 256 on
``wgmma`` in bf16, everything else (fp32 at every D, bf16 at D 16) as
3xTF32 ``mma.sync`` (each fp32 operand split into two TF32 parts, three
products a multiply: fp32-grade error). ``flash_attention.launches``
counts every launch, ``flash_attention.launches_by_route`` each route's.
k and v may have a length of their own, S_kv (the encoder-decoder's
cross-attention: text queries over the encoder's frames), without a causal
mask or a window, in the forward and in the backward.

The gradient (K1-bwd) is ``csrc/flash_attention_bwd.cu``, fp32 in and out,
its products on the tensor cores as 3xTF32 ``mma.sync`` at every head_dim,
which recomputes P from the forward's log-sum-exp per row: the 3xTF32
route writes it when asked (``return_lse``).
``FlashAttention`` is the autograd Function that pairs the two;
``flash_attention_bwd.launches`` counts the backward's calls (each launches
its kernels: three, four with KH < H).
"""

import ctypes
import functools

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128, 256)
ROUTES = ("wgmma", "tf32x3")


def route(dtype, head_dim) -> str:
    """The kernel a launch takes: "wgmma" for bf16 at D 64, 128 or 256,
    "tf32x3" otherwise (3xTF32 mma.sync, which keeps fp32's accuracy)."""
    return "wgmma" if dtype == torch.bfloat16 and head_dim in (64, 128, 256) else "tf32x3"


def entry(lib):
    """The C entry point flash_attention of `lib` (a built
    csrc/flash_attention.cu, loaded by ctypes), typed."""
    fn = lib.flash_attention
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fn():
    """The C entry point, built, loaded and typed once per process."""
    return entry(build.load("flash_attention"))


def bwd_entry(lib):
    """The C entry point flash_attention_bwd of `lib` (a built
    csrc/flash_attention_bwd.cu, loaded by ctypes), typed."""
    fn = lib.flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn():
    """The backward's C entry point, built, loaded and typed once per process."""
    return bwd_entry(build.load("flash_attention_bwd"))


def kernel_route(dtype, head_dim) -> str:
    """The route the built library itself picks for (dtype, head_dim)."""
    fn = build.load("flash_attention").flash_attention_route
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return ROUTES[0] if fn(DTYPES[dtype], head_dim) else ROUTES[1]


def check_kv_len(q, k, causal, window):
    """Raise when k's length differs from q's together with a causal mask or
    a window: both are defined on one sequence. (Shared with the plain
    version's wrapper, ``ops.flash_attention``.)"""
    if k.shape[1] != q.shape[1] and (causal or window):
        raise ValueError(f"k/v of {k.shape[1]} positions against q of {q.shape[1]}: a length "
                         "of their own takes no causal mask and no window")


def _check(q, k, v, causal=False, window=0):
    """Raise on what the kernels do not take: shapes, head_dim, dtypes,
    devices and contiguity."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"want q (B,S,H,D), k = v (B,S_kv,KH,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    kh = k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kh:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    check_kv_len(q, k, causal, window)
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(DTYPES)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention kernel needs q, k, v on one CUDA device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")


def flash_attention(q, k, v, *, scale=None, causal=True, window=0, softcap=None,
                    return_lse=False):
    """q (B,S,H,D); k,v (B,S_kv,KH,D) with KH dividing H (KH == H is the
    head-expanded layout), S_kv == S unless unmasked (no `causal`, no
    `window`). Contiguous CUDA tensors of one dtype. Returns
    (B,S,H,D) in q's dtype, and with `return_lse` also each row's
    log-sum-exp (B,H,S) fp32, which only the 3xTF32 route writes; that
    route copies q, k and v in 16-byte pieces, so each must start 16-byte
    aligned. Launches on the current stream, no sync."""
    _check(q, k, v, causal, window)
    b, s, h, d = q.shape
    if route(q.dtype, d) == "tf32x3":
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_attention's 3xTF32 route copies q, k and v in 16-byte "
                             "pieces: each must start 16-byte aligned")
    elif return_lse:
        raise ValueError(f"only the 3xTF32 route writes the log-sum-exp; {q.dtype} at "
                         f"head_dim {d} takes the {route(q.dtype, d)} route")
    out, lse = fwd_launch(_fn(), q, k, v, scale=scale, causal=causal, window=window,
                          softcap=softcap, return_lse=return_lse)
    flash_attention.launches += 1
    flash_attention.launches_by_route[route(q.dtype, d)] += 1
    return (out, lse) if return_lse else out


def fwd_launch(fn, q, k, v, *, scale=None, causal=True, window=0, softcap=None,
               return_lse=False):
    """Launch `fn` (an entry point typed by ``entry``) on inputs that
    ``flash_attention`` has checked, into a new output (and log-sum-exp,
    else None), on the current stream of q's device; raises on a CUDA
    error."""
    b, s, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    with torch.cuda.device(q.device):
        err = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, s, k.shape[1], h, k.shape[2], d, float(scale),
                 int(bool(causal)), int(window or 0), float(softcap or 0.0),
                 None if lse is None else lse.data_ptr(),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return out, lse


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)


def flash_attention_bwd(q, k, v, o, lse, do, *, scale=None, causal=True, window=0,
                        softcap=None):
    """K1-bwd: (dq, dk, dv) of `flash_attention` given its inputs, output o,
    log-sum-exp lse (B,H,S) and the output's gradient do, all fp32,
    contiguous, on one CUDA device; k and v (B,S_kv,KH,D) as in the
    forward. dk and dv sum over each kv head's query heads (a fixed order,
    no atomics). Launches on the current stream, no sync."""
    _check(q, k, v, causal, window)
    b, s, h, d = q.shape
    if q.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd is fp32 only; got {q.dtype}")
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, s):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse {tuple(lse.shape)} "
                         f"do not match q {tuple(q.shape)}")
    for t in (o, lse, do):
        if t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous():
            raise ValueError("o, lse and do must be contiguous fp32 on q's device")
    if any(t.data_ptr() % 16 for t in (q, k, v, do)):
        raise ValueError("flash_attention_bwd kernel copies q, k, v and do in 16-byte pieces: "
                         "each must start 16-byte aligned")
    out = bwd_launch(_bwd_fn(), q, k, v, o, lse, do, scale=scale, causal=causal,
                     window=window, softcap=softcap)
    flash_attention_bwd.launches += 1
    return out


def bwd_launch(fn, q, k, v, o, lse, do, *, scale=None, causal=True, window=0, softcap=None):
    """Launch `fn` (an entry point typed by ``bwd_entry``) on inputs that
    ``flash_attention_bwd`` has checked, into new (dq, dk, dv), on the
    current stream of q's device; raises on a CUDA error."""
    b, s, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    # each query head's share of dk and dv, which the kernel sums per kv head
    shares = ([torch.empty((b, k.shape[1], h, d), dtype=q.dtype, device=q.device)
               for _ in range(2)] if k.shape[2] < h else [None, None])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                 *(None if t is None else t.data_ptr() for t in shares),
                 b, s, k.shape[1], h, k.shape[2], d, float(scale), int(bool(causal)),
                 int(window or 0), float(softcap or 0.0),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error {err}")
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """K1 with K1-bwd as its gradient (fp32 on the card). Saves q, k, v, the
    output and the log-sum-exp; the backward launches one K1-bwd call."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap):
        out, lse = flash_attention(q, k, v, scale=scale, causal=causal, window=window,
                                   softcap=softcap, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(scale=scale, causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None, None
