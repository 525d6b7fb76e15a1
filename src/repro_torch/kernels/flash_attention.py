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

The gradient (K1-bwd) is ``csrc/flash_attention_bwd.cu``, which recomputes
P from the forward's log-sum-exp per row (both routes write it when asked,
``return_lse``). It has two routes (``bwd_route``), each in its inputs'
dtype: "tf32x3", its products on the tensor cores as 3xTF32 ``mma.sync``,
for fp32 at every head_dim and for bf16 at D 16 (the smoke configs' width;
the same kernels with bf16 widened exactly as it is staged and dq, dk, dv
rounded once on their store, after the sum over each kv head's query
heads); and "bf16" at D 64, 128 and 256 (the training at the reference's
production dtypes), its products as bf16 ``wgmma`` on TMA-fed 64-row tiles
into fp32, P and dX rounded to bf16 before their products as the forward
rounds P, each kv head's query heads summed inside one CTA (no workspace
for GQA; its kernels are ``BWD_BF16_KERNELS``). So both routes of the
forward have a backward of their own. ``FlashAttention`` is the autograd
Function that pairs the forward with the backward of its dtype;
``flash_attention_bwd.launches`` counts the backward's calls (each
launches its kernels: three, four on the 3xTF32 route with KH < H or in
bf16), ``flash_attention_bwd.launches_by_route`` each route's.
"""

import ctypes
import functools

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128, 256)
ROUTES = ("wgmma", "tf32x3")
BWD_ROUTES = ("tf32x3", "bf16")
# the bf16 backward's kernels, as a profiler names them (by substring)
BWD_BF16_KERNELS = ("flash_bwd_bf16_delta", "flash_bwd_wgmma_dkdv", "flash_bwd_wgmma_dq")
BWD_TILE = 64   # rows of the bf16 backward's tiles: its stats workspace is padded to them


def route(dtype, head_dim) -> str:
    """The kernel a launch takes: "wgmma" for bf16 at D 64, 128 or 256,
    "tf32x3" otherwise (3xTF32 mma.sync, which keeps fp32's accuracy)."""
    return "wgmma" if dtype == torch.bfloat16 and head_dim in (64, 128, 256) else "tf32x3"


def bwd_route(dtype, head_dim):
    """The backward kernel a K1-bwd call takes: "tf32x3" for fp32 at every
    head_dim and for bf16 at D 16, "bf16" for bf16 at D 64, 128 or 256
    (each the backward of the route ``route`` gives the forward); None
    where there is none (another dtype or head_dim), and a gradient through
    K1 raises on the card."""
    if head_dim not in HEAD_DIMS:
        return None
    if dtype == torch.float32 or (dtype == torch.bfloat16 and head_dim == 16):
        return "tf32x3"
    return "bf16" if dtype == torch.bfloat16 else None


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


# the C entry point of each (route, dtype) in csrc/flash_attention_bwd.cu
BWD_ENTRIES = {("tf32x3", torch.float32): "flash_attention_bwd",
               ("tf32x3", torch.bfloat16): "flash_attention_bwd_tf32x3_bf16",
               ("bf16", torch.bfloat16): "flash_attention_bwd_bf16"}


def bwd_entry(lib, route="tf32x3", dtype=torch.float32):
    """The C entry point of `route` on `dtype` in `lib` (a built
    csrc/flash_attention_bwd.cu, loaded by ctypes), typed: the 3xTF32
    route's (``BWD_ENTRIES``: 12 pointers, its workspaces delta and the GQA
    shares) or the bf16 route's (10: its workspace the stats)."""
    fn = getattr(lib, BWD_ENTRIES[route, dtype])
    fn.argtypes = [ctypes.c_void_p] * (12 if route == "tf32x3" else 10) + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn(route="tf32x3", dtype=torch.float32):
    """The backward's C entry point of `route` on `dtype`, built, loaded and
    typed once per process."""
    return bwd_entry(build.load("flash_attention_bwd"), route, dtype)


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
    log-sum-exp (B,H,S) fp32, which both routes write. The 3xTF32 route
    copies q, k and v in 16-byte pieces, so each must start 16-byte
    aligned. Launches on the current stream, no sync."""
    _check(q, k, v, causal, window)
    b, s, h, d = q.shape
    if route(q.dtype, d) == "tf32x3" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention's 3xTF32 route copies q, k and v in 16-byte "
                         "pieces: each must start 16-byte aligned")
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
    log-sum-exp lse (B,H,S) fp32 and the output's gradient do, contiguous,
    on one CUDA device; k and v (B,S_kv,KH,D) as in the forward. q, k, v,
    o and do fp32 or bf16 at D 16 (the 3xTF32 route), or bf16 at D 64, 128
    or 256 (the bf16 route), and dq, dk, dv in that dtype. dk and dv sum over each kv
    head's query heads (a fixed order, no atomics). Launches on the current
    stream (the bf16 route runs its dK/dV kernel on a stream of its own
    beside it, forked from and joined back to the current one), no sync."""
    _check(q, k, v, causal, window)
    b, s, h, d = q.shape
    path = bwd_route(q.dtype, d)
    if path is None:
        raise TypeError(f"flash_attention_bwd takes fp32 and bf16 at head_dims {HEAD_DIMS}; "
                        f"got {q.dtype} at head_dim {d}")
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, s):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse {tuple(lse.shape)} "
                         f"do not match q {tuple(q.shape)}")
    for t, dtype in ((o, q.dtype), (do, q.dtype), (lse, torch.float32)):
        if t.dtype != dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"o and do must be contiguous {q.dtype}, lse contiguous fp32, on "
                             "q's device")
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("flash_attention_bwd kernel copies q, k, v, o and do in 16-byte "
                         "pieces: each must start 16-byte aligned")
    out = bwd_launch(_bwd_fn(path, q.dtype), q, k, v, o, lse, do, scale=scale, causal=causal,
                     window=window, softcap=softcap)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_route[path] += 1
    return out


def bwd_launch(fn, q, k, v, o, lse, do, *, scale=None, causal=True, window=0, softcap=None):
    """Launch `fn` (the entry point of the route ``bwd_route`` picks, typed
    by ``bwd_entry``) on inputs that ``flash_attention_bwd`` has checked,
    into new (dq, dk, dv), on the current stream of q's device; raises on a
    CUDA error."""
    b, s, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    f32 = dict(dtype=torch.float32, device=q.device)
    if bwd_route(q.dtype, d) == "bf16":
        # each query row's lse and Delta, padded to whole tiles
        work = [torch.empty((b, h, 2, -(-s // BWD_TILE) * BWD_TILE), **f32)]
    else:
        # Delta, and each query head's share of dk and dv, which the kernel
        # sums per kv head (and rounds, in bf16)
        work = [torch.empty((b, h, s), **f32)] + (
            [torch.empty((b, k.shape[1], h, d), **f32) for _ in range(2)]
            if k.shape[2] < h or q.dtype != torch.float32 else [None, None])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 *(None if t is None else t.data_ptr() for t in work),
                 b, s, k.shape[1], h, k.shape[2], d, float(scale), int(bool(causal)),
                 int(window or 0), float(softcap or 0.0),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error {err}")
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_route = dict.fromkeys(BWD_ROUTES, 0)


class FlashAttention(torch.autograd.Function):
    """K1 with K1-bwd as its gradient on the card: fp32 and bf16 at D 16
    (3xTF32 forward and backward) or bf16 at D 64, 128 and 256 (the wgmma
    forward, the bf16 backward). Saves q, k, v, the output and the
    log-sum-exp; the backward launches one K1-bwd call."""

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
