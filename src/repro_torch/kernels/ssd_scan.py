"""K3: the Mamba2 SSD chunked scan — the CUDA kernel's Python wrapper.

Replaces ``repro.kernels.ssd_scan.ssd_scan`` (Pallas, TPU). The kernels
are in ``csrc/ssd_scan.cu``; its plain PyTorch version is
``ops.ssd_scan_plain``, which ``ops.ssd_scan`` takes for CPU tensors. The
``.cu`` picks one of three routes by dtype, P and N alone (``route``):
bf16 with P a multiple of 64 and N 64 or 128, which the serving path
calls, runs the chunk's products on the tensor cores (wgmma); fp32, which
the train path calls, takes the 3xTF32 route (``"tf32x3"``: the
chunk-parallel split of ``csrc/ssd_tf32.cuh``, each chunk's state, the
passing across chunks, then each chunk's y, every product as three TF32
``mma.sync`` products on the tensor cores); bf16 at other widths runs on
the fp32 CUDA cores. ``ssd_scan.launches`` counts every call,
``ssd_scan.launches_by_route`` each route's.

The gradient (K3-bwd) is ``csrc/ssd_scan_bwd.cu``, fp32 on the same
3xTF32 split, which recomputes the chunk states from the inputs; its
plain version is ``ops.ssd_scan_bwd_plain``. ``SSDScan`` is the autograd
Function that pairs the two. ``tf32x3_plan`` gives the launches of
either, with their shared memory and CTAs an SM from the built library.
"""

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPES

MAX_STATE = 128   # largest N (NMAX in the source)
CHUNK = 64        # steps a chunk in both kernels (L in the sources)
PT = 64           # head columns p a unit of the 3xTF32 route (PT in ssd_tf32.cuh)
ROUTES = ("wgmma", "tf32x3", "cuda_cores")   # the indices ssd_scan_route returns
FWD_KERNELS = ("ssd_state_kernel", "ssd_pass_kernel", "ssd_out_kernel")
BWD_KERNELS = ("ssd_bwd_state_kernel", "ssd_bwd_pass_kernel", "ssd_bwd_chunk_kernel",
               "ssd_bwd_reduce_bc_kernel", "ssd_bwd_reduce_dt_kernel")


def route(dtype, p, n) -> str:
    """The kernels a launch takes: "wgmma" for bf16 with P a multiple of 64
    and N 64 or 128, "tf32x3" for fp32, "cuda_cores" for bf16 at other
    widths."""
    if dtype == torch.float32:
        return "tf32x3"
    return "wgmma" if p % 64 == 0 and n in (64, 128) else "cuda_cores"


@functools.cache
def _fn():
    """The C entry point, built, loaded and typed once per process."""
    fn = build.load("ssd_scan").ssd_scan
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan(b, h, p) -> tuple:
    """(heads a CTA, CTAs) of a launch on the one-pass routes (wgmma, CUDA
    cores): one CTA per (64 columns p, head, batch); the tensor-core
    route's CTA is two warpgroups, the CUDA-core route's 256 threads."""
    return 1, b * h * -(-p // 64)


def tf32x3_plan(b, s, h, p, n, g=1, *, backward=False, sms=None) -> dict:
    """Each launch of the 3xTF32 route (``backward``: K3-bwd) at (B, S, H,
    P, N, G): {kernel: {"ctas", "threads"}}; with `sms` (the card's SM
    count) also "smem" (bytes), "ctas_per_sm" (from the built library's
    occupancy query) and "waves" on those SMs. Every unit of the chunk
    passes is a (chunk, 64 columns p, head, batch); the passing across
    chunks is one thread 16 elements of each head's (P, N) state (4 where
    P N is not a multiple of 4; the tensors the wrapper allocates are
    aligned)."""
    units = -(-s // CHUNK) * -(-p // PT) * h * b
    elems = -(-(p * n) // (4096 if p * n % 4 == 0 else 1024)) * h * b   # 16 elements a thread
    if backward:
        per = 4 if n % 4 == 0 else 1
        out = dict(zip(BWD_KERNELS, (
            {"ctas": 2 * units, "threads": 256}, {"ctas": 2 * elems, "threads": 256},
            {"ctas": units, "threads": 256}, {"ctas": -(-(b * s * g * n // per) // 64),
                                              "threads": 256},
            {"ctas": -(-(b * s * h + h) // 256), "threads": 256})))
        query = "ssd_scan_bwd_occupancy"
    else:
        out = dict(zip(FWD_KERNELS, ({"ctas": units, "threads": 256},
                                     {"ctas": elems, "threads": 256},
                                     {"ctas": units, "threads": 128})))
        query = "ssd_scan_tf32x3_occupancy"
    if sms is not None:
        fn = getattr(build.load("ssd_scan_bwd" if backward else "ssd_scan"), query)
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        for i, row in enumerate(out.values()):
            smem, per_sm = ctypes.c_int(), ctypes.c_int()
            err = fn(i, ctypes.byref(smem), ctypes.byref(per_sm))
            if err:
                raise RuntimeError(f"{query}({i}) failed: CUDA error {err}")
            row.update(smem=smem.value, ctas_per_sm=per_sm.value,
                       waves=row["ctas"] / max(per_sm.value * sms, 1))
    return out


def kernel_route(dtype, p, n) -> str:
    """The route the built library itself picks for (dtype, P, N)."""
    fn = build.load("ssd_scan").ssd_scan_route
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    return ROUTES[fn(DTYPES[dtype], p, n)]


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
    # the 3xTF32 route's workspaces: each chunk's state, then the state
    # entering it; each chunk's cs_L
    nc = -(-s // CHUNK)
    work = ((torch.empty((bsz, h, nc, p, n), dtype=torch.float32, device=x.device),
             torch.empty((bsz, h, nc), dtype=torch.float32, device=x.device))
            if path == "tf32x3" else (None, None))
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    fn = _fn()
    with torch.cuda.device(x.device):
        err = fn(DTYPES[x.dtype], *(ptr(t) for t in (x, dt, a, b, c, h0, y, state, *work)),
                 bsz, s, h, p, g, n, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    ssd_scan.launches_by_route[path] += 1
    return y, state


ssd_scan.launches = 0
ssd_scan.launches_by_route = dict.fromkeys(ROUTES, 0)


@functools.cache
def _bwd_fn():
    """The backward's C entry point, built, loaded and typed once per process."""
    fn = build.load("ssd_scan_bwd").ssd_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_scan_bwd(x, dt, a, b, c, h0, dy, dstate):
    """K3-bwd: (dx, ddt, da, db, dc, dh0) of ``ssd_scan``'s (y, final state)
    given the same inputs (h0 None: zeros) and the gradients dy (B,S,H,P)
    and dstate (B,H,P,N) (None: zeros). All fp32, contiguous, on one CUDA
    device. dh0 is None when h0 is. db and dc sum over each group's heads,
    da over batch and steps, in a fixed order (no atomics). Launches on the
    current stream, no sync."""
    if x.dim() != 4 or b.dim() != 4 or b.shape != c.shape or dy.shape != x.shape:
        raise ValueError(f"want x = dy (B,S,H,P), b = c (B,S,G,N); got {tuple(x.shape)}, "
                         f"{tuple(dy.shape)}, {tuple(b.shape)}, {tuple(c.shape)}")
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if b.shape[:2] != (bsz, s) or h % g or dt.shape != (bsz, s, h) or a.shape != (h,):
        raise ValueError(f"dt {tuple(dt.shape)}, a {tuple(a.shape)}, b/c {tuple(b.shape)} "
                         f"do not match x {tuple(x.shape)}")
    if n > MAX_STATE or min(x.shape) == 0:
        raise ValueError(f"state size {n} > {MAX_STATE}, or an empty input {tuple(x.shape)}")
    if any(t is not None and t.shape != (bsz, h, p, n) for t in (h0, dstate)):
        raise ValueError(f"h0 and dstate must be {(bsz, h, p, n)}")
    ins = tuple(t for t in (x, dt, a, b, c, h0, dy, dstate) if t is not None)
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"ssd_scan_bwd is fp32 only; got {[t.dtype for t in ins]}")
    if not (x.is_cuda and all(t.device == x.device for t in ins)):
        raise ValueError("ssd_scan_bwd kernel needs every input on one CUDA device")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("ssd_scan_bwd kernel needs contiguous inputs")
    npt, nc = -(-p // PT), -(-s // CHUNK)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=x.device)   # noqa: E731
    dx, ddt, da, db, dc = new(*x.shape), new(*dt.shape), new(h), new(*b.shape), new(*c.shape)
    dh0 = None if h0 is None else new(*h0.shape)
    # the chunk states and their gradients, each chunk's cs_L, and each
    # unit's share of what sums over heads, p tiles, chunks or batch, which
    # the reduce kernels add in a fixed order
    states, dstates, decay = new(bsz, h, nc, p, n), new(bsz, h, nc, p, n), new(bsz, h, nc)
    dbp, dcp = new(npt, bsz, s, h, n), new(npt, bsz, s, h, n)
    ddtp, dap = new(npt, bsz, s, h), new(npt, bsz, nc, h)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    with torch.cuda.device(x.device):
        err = _bwd_fn()(*(ptr(t) for t in (x, dt, a, b, c, h0, dy, dstate, dx, ddt, da, db, dc,
                                           dh0, states, dstates, decay, dbp, dcp, ddtp, dap)),
                        bsz, s, h, p, g, n, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan_bwd launch failed: CUDA error {err}")
    ssd_scan_bwd.launches += 1
    return dx, ddt, da, db, dc, dh0


ssd_scan_bwd.launches = 0


class SSDScan(torch.autograd.Function):
    """K3 (fp32) with K3-bwd as its gradient. Saves the inputs; the
    backward recomputes the chunk states. Returns (y, final state), both
    differentiable."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, h0):
        y, state = ssd_scan(x, dt, a, b, c, h0=h0, return_state=True)
        ctx.save_for_backward(x, dt, a, b, c, h0)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, b, c, h0 = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dstate = None if dstate is None else dstate.contiguous()
        return ssd_scan_bwd(x, dt, a, b, c, h0, dy, dstate)
