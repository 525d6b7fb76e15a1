"""K2: decode attention — the CUDA kernels' Python wrapper.

Replaces ``repro.kernels.decode_attention.decode_attention`` (Pallas, TPU).
The kernels are in ``csrc/decode_attention.cu``: a split-S pass
(``decode_split_kernel``, one CTA per chunk of cache positions and kv
head, serving all of that kv head's query heads) and a combine pass
(``decode_combine_kernel``), launched by one C call. ``plan`` picks the
chunk from shapes alone. The plain PyTorch version is
``ref.decode_attention_ref``, which ``ops.decode_attention`` takes for CPU
tensors. ``softcap`` caps the scaled logits in the split pass, as gemma2's
attention does; the Pallas kernel has none, the JAX model's decode
(``attend_ref``) has it. With ``return_lse`` the combine pass writes the
output in fp32 and each row's log-sum-exp beside it, for the combine of a
sequence-sharded cache's partials over the ranks
(``nn.attention._decode_call``); no pass is added.
"""

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS

CHUNKS = (16, 32, 64, 128, 256)   # the positions a split may cover
SMEM_MAX = 232448                 # shared memory a block may opt into on an H100


def smem_bytes(chunk, g, d, esz) -> int:
    """Shared memory of one split CTA, a copy of ``smem_bytes`` in the .cu
    (a CPU test holds the two equal): q for its g query heads, the g x
    chunk logits in fp32, and its chunk of K (rows padded by 16 bytes) and
    V; q, K and V of `esz` bytes a value."""
    return g * d * esz + 4 * g * chunk + chunk * (d * esz + 16) + chunk * d * esz


@functools.lru_cache(maxsize=None)
def plan(b, s, h, kh, d, dtype, num_sms) -> tuple:
    """(chunk, splits) of a call, from shapes alone: the largest chunk of
    CHUNKS, up to the power of two that covers S and within SMEM_MAX, that
    gives B * KH * splits >= 2 * num_sms CTAs, else the smallest; splits =
    ceil(S / chunk). It never reads `lengths`, so a CUDA graph can capture
    the call."""
    g = h // kh
    top = max(CHUNKS[0], 1 << (s - 1).bit_length())
    fits = [c for c in CHUNKS
            if c <= top and smem_bytes(c, g, d, dtype.itemsize) <= SMEM_MAX]
    if not fits:
        raise ValueError(f"{g} query heads per kv head at head_dim {d} do not fit "
                         "one CTA's shared memory")
    full = [c for c in fits if b * kh * -(-s // c) >= 2 * num_sms]
    chunk = full[-1] if full else fits[0]
    return chunk, -(-s // chunk)


@functools.cache
def num_sms(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _fn():
    """The C entry point, built, loaded and typed once per process."""
    fn = build.load("decode_attention").decode_attention
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q, k, v, lengths, *, scale=None, softcap=None, return_lse=False):
    """q (B,H,D); k,v (B,S,KH,D) with KH dividing H; lengths (B,) int32.
    Contiguous CUDA tensors, q/k/v of one dtype, k and v 16-byte aligned.
    `softcap` (None or 0: none) caps each scaled logit to cap * tanh(s / cap).
    Returns (B,H,D) in q's dtype; with `return_lse`, (out (B,H,D) fp32,
    lse (B,H) fp32), lse the natural log of the sum of exp over each row's
    valid logits (-1e30 on a length-0 row). Launches on the current stream,
    no sync."""
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
    kp, vp = k.data_ptr(), v.data_ptr()
    if kp % 16 or vp % 16:
        raise ValueError("decode_attention kernel copies k and v 16 bytes at a time: "
                         "they must be 16-byte aligned")
    if softcap is not None and softcap < 0:
        raise ValueError(f"softcap must be positive or None, got {softcap}")
    scale = scale if scale is not None else d ** -0.5
    chunk, splits = plan(b, s, h, kh, d, q.dtype, num_sms(q.device.index))
    out = torch.empty(q.shape, dtype=torch.float32 if return_lse else q.dtype, device=q.device)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device) if return_lse else None
    ws = torch.empty((splits, b, h, d + 2), dtype=torch.float32, device=q.device)
    fn = _fn()
    with torch.cuda.device(q.device):
        err = fn(DTYPES[q.dtype], q.data_ptr(), kp, vp, lengths.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), ws.data_ptr(), b, s, h, kh, d,
                 chunk, float(scale), float(softcap or 0.0),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {err}")
    decode_attention.launches += 1
    if return_lse:
        decode_attention.launches_with_lse += 1
        return out, lse
    return out


decode_attention.launches = 0
decode_attention.launches_with_lse = 0   # of those, the launches that wrote the log-sum-exp
