"""Encoder-decoder backbone (Seamless-M4T v2 text/audio).

Mirrors ``repro.models.encdec``. The modality frontend is a stub: the
encoder consumes precomputed frame embeddings (B, F, frontend_dim),
projected to d_model in ``cfg.compute_dtype``. Encoder: unmasked ("bidir")
self-attention with rope on the frame positions (K1 without its causal
mask), then a ReLU MLP with biases and no gate. Decoder: causal
self-attention (K1 in the prefill, K2 in decode against its KV cache), then
cross-attention over the encoder's output with no rope and no mask (K1 with
k and v of the F frames in the prefill, K2 with every frame valid in
decode), then the MLP. Layers run in a Python loop over ``nn.ModuleList``s,
in place of the JAX package's ``lax.scan`` over stacked params.

The cache keeps, per decoder layer, the self-attention's ``k``, ``v`` and
``pos`` and the cross-attention's fixed ``xk`` and ``xv`` (B, F, K, hd),
plus ``index``. As in the reference, ``init_cache`` makes ``xk``/``xv`` in
the cache dtype, and ``prefill`` leaves the encoder's K/V there in the
compute dtype: the reference's prefill replaces them by the encoder
output's own arrays. With tp > 1 every attention holds
``cfg.padded_heads`` query heads, the padded ones masked before ``wo``,
as the reference's. Under a sharding context the residual stream and the
cross-attention's q are constrained where the reference's are, and the
cache is made of DTensors.
"""

import functools

import torch
from torch import nn

from repro_torch.device import dtype_of, resolve, seeded_generator
from repro_torch.models.common import (FrontendProj, ModelBundle, ModelOutputs, ValueHead,
                                      as_tokens, maybe_remat, value_head)
from repro_torch.nn.attention import (Attention, attention, cross_attention, cross_kv,
                                      decode_attention, make_cache)
from repro_torch.nn.embed import Embed, embed, unembed
from repro_torch.nn.mlp import MLP, mlp
from repro_torch.nn.norms import Norm, apply_norm
from repro_torch.sharding.ctx import constrain, distribute_cache


def check_supported(cfg):
    """Raise for a config that is not an encoder-decoder."""
    if cfg.family != "encdec":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not an encoder-decoder")


class EncLayer(nn.Module):
    """norm1, attn, norm2 and the ungated MLP with biases: the reference's
    ``_init_enc_layer``."""

    def __init__(self, cfg, **kw):
        super().__init__()
        norm = functools.partial(Norm, cfg.d_model, kind=cfg.norm, **kw)
        self.norm1 = norm()
        self.attn = Attention(cfg, **kw)
        self.norm2 = norm()
        self.mlp = MLP(cfg.d_model, cfg.d_ff, gated=False, bias=True, **kw)


class DecLayer(EncLayer):
    """An encoder layer's params, then norm_x and the cross-attention xattn:
    the reference's ``_init_dec_layer``."""

    def __init__(self, cfg, **kw):
        super().__init__(cfg, **kw)
        self.norm_x = Norm(cfg.d_model, kind=cfg.norm, **kw)
        self.xattn = Attention(cfg, **kw)


class EncDec(nn.Module):
    """Parameters of the encoder-decoder, built directly in `dtype` on
    `device` from a seeded torch.Generator on that device."""

    def __init__(self, cfg, seed=0, device="cuda", dtype=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve(device)
        gen = seeded_generator(dev, seed)
        kw = dict(gen=gen, dtype=dtype_of(dtype or cfg.param_dtype), device=dev)
        self.embed = Embed(cfg, **kw)
        self.frontend = FrontendProj(cfg, **kw)
        self.enc = nn.ModuleList(EncLayer(cfg, **kw) for _ in range(cfg.enc_layers))
        self.dec = nn.ModuleList(DecLayer(cfg, **kw) for _ in range(cfg.dec_layers))
        self.enc_norm = Norm(cfg.d_model, kind=cfg.norm, **kw)
        self.final_norm = Norm(cfg.d_model, kind=cfg.norm, **kw)
        self.value_head = ValueHead(cfg.d_model, **kw)

    @property
    def device(self):
        return self.embed.table.device


def _enc_layer(cfg, p, x, positions):
    x = constrain(x, "act_batch", "act_res_seq", "act_embed")
    h = apply_norm(p.norm1, x, cfg.norm_eps)
    y, _ = attention(cfg, p.attn, h, positions, kind="bidir")
    x = x + y
    h = apply_norm(p.norm2, x, cfg.norm_eps)
    return x + mlp(p.mlp, h, "relu")


def _encode(cfg, params, frames, remat="none"):
    """frames (B,F,frontend_dim) -> the encoder's output (B,F,d)."""
    dt = dtype_of(cfg.compute_dtype)
    frames = torch.as_tensor(frames, device=params.device)
    x = frames.to(dt) @ params.frontend.w.to(dt)
    positions = torch.arange(x.shape[1], device=x.device)
    layer = maybe_remat(functools.partial(_enc_layer, cfg), remat)
    for p in params.enc:
        x = layer(p, x, positions)
    return apply_norm(params.enc_norm, x, cfg.norm_eps)


def _dec_layer(cfg, p, x, positions, xk, xv, cache=None, decode=False, index=None):
    """One decoder layer over the cross K/V (xk, xv). Returns (x, the self-
    attention's cache entry or None)."""
    x = constrain(x, "act_batch", "act_res_seq", "act_embed")
    h = apply_norm(p.norm1, x, cfg.norm_eps)
    if decode:
        y, new_cache = decode_attention(cfg, p.attn, h, index, cache)
    else:
        y, new_cache = attention(cfg, p.attn, h, positions, cache=cache)
    x = x + y
    h = apply_norm(p.norm_x, x, cfg.norm_eps)
    x = x + cross_attention(cfg, p.xattn, h, xk, xv, decode=decode)
    h = apply_norm(p.norm2, x, cfg.norm_eps)
    return x + mlp(p.mlp, h, "relu"), new_cache


def _outputs(cfg, params, x):
    """The final norm, the untied unembed's fp32 logits (no softcap) and the
    value of every position: the reference's ``_outputs``."""
    h = apply_norm(params.final_norm, x, cfg.norm_eps)
    return ModelOutputs(logits=unembed(cfg, params.embed, h),
                        value=value_head(params.value_head, h))


def _embed_tokens(cfg, params, tokens):
    return embed(cfg, params.embed, as_tokens(params, tokens))


def encdec_forward(cfg, params, batch):
    enc_out = _encode(cfg, params, batch["frontend"], cfg.remat)
    x = _embed_tokens(cfg, params, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)

    def layer(p, x):
        xk, xv = cross_kv(cfg, p.xattn, enc_out)
        return _dec_layer(cfg, p, x, positions, xk, xv)[0]
    layer = maybe_remat(layer, cfg.remat)
    for p in params.dec:
        x = layer(p, x)
    return _outputs(cfg, params, x)


def _cross_entry(cfg, batch, max_len, dtype, device, xk, xv):
    entry = make_cache(cfg, batch, max_len, "global", dtype, device)
    entry.update(xk=xk, xv=xv)
    return entry


def encdec_init_cache(cfg, batch, max_len, dtype=torch.bfloat16, device="cuda"):
    """{'dec': per decoder layer {'k', 'v' (B,max_len,K,hd), 'pos' (max_len,),
    'xk', 'xv' (B,frontend_tokens,K,hd) zeros}, all in `dtype` but pos,
    'index': 0-d int32}."""
    dev = resolve(device)
    shape = (batch, cfg.frontend_tokens, cfg.num_kv_heads, cfg.head_dim)

    def zeros():
        return torch.zeros(shape, dtype=dtype, device=dev)
    return distribute_cache({
        "dec": [_cross_entry(cfg, batch, max_len, dtype, dev, zeros(), zeros())
                for _ in range(cfg.dec_layers)],
        "index": torch.zeros((), dtype=torch.int32, device=dev)})


def encdec_prefill(cfg, params, batch, max_len, dtype=torch.bfloat16):
    """The encoder over batch["frontend"], then the decoder over
    batch["tokens"] (B,S), filling each layer's self-attention cache of
    `max_len` slots in `dtype` and keeping its cross K/V (the encoder
    output's dtype, as the reference's prefill leaves them)."""
    enc_out = _encode(cfg, params, batch["frontend"])
    x = _embed_tokens(cfg, params, batch["tokens"])
    b, s = x.shape[:2]
    if max_len is None or s > max_len:
        raise ValueError(f"prompt of {s} positions needs max_len >= {s}, got {max_len}")
    positions = torch.arange(s, device=x.device)
    caches = []
    for p in params.dec:
        xk, xv = cross_kv(cfg, p.xattn, enc_out)
        entry = distribute_cache(_cross_entry(cfg, b, max_len, dtype, x.device, xk, xv))
        x, _ = _dec_layer(cfg, p, x, positions, xk, xv, cache=entry)
        caches.append(entry)
    index = torch.full((), s, dtype=torch.int32, device=x.device)
    return _outputs(cfg, params, x), {"dec": caches, "index": index}


def encdec_decode_step(cfg, params, tokens_t, caches):
    """tokens_t (B,1). Uses caches['index'] as the write position; the caller
    keeps index < max_len (the self-attention caches are written in
    place)."""
    x = _embed_tokens(cfg, params, tokens_t)
    index = caches["index"]
    for p, c in zip(params.dec, caches["dec"]):
        x, _ = _dec_layer(cfg, p, x, None, c["xk"], c["xv"], cache=c, decode=True,
                          index=index)
    return _outputs(cfg, params, x), dict(caches, index=index + 1)


def make_encdec(cfg) -> ModelBundle:
    check_supported(cfg)
    return ModelBundle(
        cfg=cfg,
        init=lambda seed=0, device="cuda", dtype=None: EncDec(cfg, seed, device, dtype),
        forward=lambda params, batch: encdec_forward(cfg, params, batch),
        init_cache=lambda batch, max_len, dtype=torch.bfloat16, device="cuda":
            encdec_init_cache(cfg, batch, max_len, dtype, device),
        prefill=lambda params, batch, max_len=None, dtype=torch.bfloat16:
            encdec_prefill(cfg, params, batch, max_len, dtype),
        decode_step=lambda params, tokens_t, caches:
            encdec_decode_step(cfg, params, tokens_t, caches),
    )
