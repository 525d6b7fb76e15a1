"""Public wrappers for the attention kernels, dispatching on the device.

Mirrors ``repro.kernels.ops`` and keeps its signatures and its (B,S,H,D)
layout. A CPU tensor takes the plain PyTorch version (``ref.py``); a CUDA
tensor launches the hand-written kernel or raises — there is no fallback.
Unlike the JAX wrappers, k and v may keep fewer heads than q (GQA, KH
dividing H): the kernels read the unexpanded cache, and the plain versions
expand it first. ``scale`` defaults to D**-0.5, as in the JAX package.
"""

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels.ref import attention_ref, decode_attention_ref

KERNELS = {"flash_attention": _flash.flash_attention,
           "decode_attention": _decode.decode_attention}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def _expand_kv(k, n_heads):
    """(B,S,KH,D) -> (B,S,H,D), kv head j serving query heads j*H/KH ..
    (j+1)*H/KH - 1, as jnp.repeat(axis=2). A broadcast and copy: unlike
    repeat_interleave it never synchronises with the device."""
    b, s, kh, d = k.shape
    if n_heads == kh:
        return k
    return k[:, :, :, None].expand(b, s, kh, n_heads // kh, d).reshape(b, s, n_heads, d)


def _on_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"inputs must all be on the CPU or all on CUDA; got {devs}")


def flash_attention_plain(q, k, v, *, causal=True, window=0, softcap=None,
                          scale=None):
    """Plain PyTorch version of `flash_attention` (any device)."""
    b, s, h, d = q.shape
    fold = lambda x: x.transpose(1, 2).reshape(b * h, s, d)
    out = attention_ref(fold(q), fold(_expand_kv(k, h)), fold(_expand_kv(v, h)),
                        scale=scale, causal=causal, window=window,
                        softcap=softcap)
    return out.reshape(b, h, s, d).transpose(1, 2)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=None, scale=None):
    """(B,S,H,D) q; (B,S,KH,D) k, v with KH dividing H. -> (B,S,H,D)."""
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    return _flash.flash_attention(q, k, v, scale=scale, causal=causal,
                                  window=window, softcap=softcap)


def decode_attention_plain(q, k, v, lengths, *, scale=None):
    """Plain PyTorch version of `decode_attention` (any device)."""
    h = q.shape[1]
    return decode_attention_ref(q, _expand_kv(k, h), _expand_kv(v, h), lengths,
                                scale=scale)


def decode_attention(q, k, v, lengths, *, scale=None):
    """q (B,H,D); k,v (B,S,KH,D) with KH dividing H; lengths (B,)."""
    if _on_cpu(q, k, v, lengths):
        return decode_attention_plain(q, k, v, lengths, scale=scale)
    return _decode.decode_attention(q, k, v, lengths, scale=scale)
