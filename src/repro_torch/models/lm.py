"""Decoder-only LM, dense family with global attention (qwen3 first).

Mirrors ``repro.models.lm``. Blocks live in an ``nn.ModuleList`` and run in
a Python loop; this replaces the JAX package's ``lax.scan`` over stacked
parameters (``convert.params_from_jax`` unstacks them). What qwen3 does not
use (MoE, MLA, MTP, the modality frontend, local attention, softcaps, the
gemma and starcoder2 options) raises NotImplementedError until its slice
lands.
"""

import torch
from torch import nn

from repro_torch.device import dtype_of, resolve
from repro_torch.models.common import ModelBundle, ValueHead, as_tokens, lm_outputs
from repro_torch.nn.attention import (Attention, attention, decode_attention,
                                      make_cache)
from repro_torch.nn.embed import Embed, embed
from repro_torch.nn.mlp import ACTS, MLP, mlp
from repro_torch.nn.norms import Norm, apply_norm


def check_supported(cfg):
    """Raise for the parts of the JAX LM that are not ported yet."""
    missing = [what for what, on in (
        ("MoE", cfg.family == "moe" or cfg.num_experts),
        ("MLA", cfg.mla),
        ("MTP", cfg.mtp_depth),
        ("the modality frontend", cfg.frontend_tokens),
        ("first dense layers", cfg.first_dense_layers),
        ("the R2D2 q head", cfg.algo == "r2d2" and cfg.num_actions),
        ("local attention layers (gemma2 slice)", cfg.attn_pattern != ("global",)),
        ("softcaps (gemma2 slice)", cfg.attn_softcap or cfg.final_softcap),
        ("gemma norms and embeddings (gemma2 slice)",
         cfg.gemma_scale or cfg.post_block_norm or cfg.embed_scale or cfg.tie_embeddings),
        ("layernorm, biases (starcoder2 / qwen2.5 slices)",
         cfg.norm != "rmsnorm" or cfg.qkv_bias or cfg.mlp_bias),
        (f"activation {cfg.act!r}", cfg.act not in ACTS),
        ("padded heads (tp > 1)", cfg.padded_heads != cfg.num_heads),
    ) if on]
    if cfg.family != "dense" or missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {', '.join(missing) or cfg.family}")


class Block(nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        self.norm1 = Norm(cfg.d_model, **kw)
        self.norm2 = Norm(cfg.d_model, **kw)
        self.attn = Attention(cfg, **kw)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, **kw)


class LM(nn.Module):
    """Parameters of the dense LM, built directly in `dtype` on `device`
    from a seeded torch.Generator on that device."""

    def __init__(self, cfg, seed=0, device="cuda", dtype=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        kw = dict(gen=gen, dtype=dtype_of(dtype or cfg.param_dtype), device=dev)
        self.embed = Embed(cfg, **kw)
        self.blocks = nn.ModuleList(Block(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_norm = Norm(cfg.d_model, **kw)
        self.value_head = ValueHead(cfg.d_model, **kw)

    @property
    def device(self):
        return self.embed.table.device


def _block(cfg, p, x, positions, cache=None, decode=False, index=None):
    """One transformer block. Returns (x, new_cache)."""
    h = apply_norm(p.norm1, x, cfg.norm_eps)
    if decode:
        y, new_cache = decode_attention(cfg, p.attn, h, index, cache)
    else:
        y, new_cache = attention(cfg, p.attn, h, positions, cache=cache)
    x = x + y
    h = apply_norm(p.norm2, x, cfg.norm_eps)
    return x + mlp(p.ffn, h, cfg.act), new_cache


def _run_blocks(cfg, params, x, positions, caches=None, mode="train"):
    decode = mode == "decode"
    index = caches["index"] if decode else None
    for i, p in enumerate(params.blocks):
        c = None if caches is None else caches["layers"][i]
        x, _ = _block(cfg, p, x, positions, cache=c, decode=decode, index=index)
    return x


def lm_forward(cfg, params, batch):
    x = embed(cfg, params.embed, as_tokens(params, batch["tokens"]))
    positions = torch.arange(x.shape[1], device=x.device)
    return lm_outputs(cfg, params, _run_blocks(cfg, params, x, positions))


def lm_init_cache(cfg, batch, max_len, dtype=torch.bfloat16, device="cuda"):
    """{'layers': one cache entry per layer, 'index': 0-d int32 tensor}."""
    dev = resolve(device)
    return {"layers": [make_cache(cfg, batch, max_len, "global", dtype, dev)
                       for _ in range(cfg.num_layers)],
            "index": torch.zeros((), dtype=torch.int32, device=dev)}


def lm_prefill(cfg, params, batch, max_len, dtype=torch.bfloat16):
    tokens = as_tokens(params, batch["tokens"])
    b, s = tokens.shape
    if max_len is None or s > max_len:
        raise ValueError(f"prompt of {s} tokens needs max_len >= {s}, got {max_len}")
    x = embed(cfg, params.embed, tokens)
    caches = lm_init_cache(cfg, b, max_len, dtype, params.device)
    positions = torch.arange(s, device=x.device)
    x = _run_blocks(cfg, params, x, positions, caches, mode="prefill")
    caches["index"] = torch.full((), s, dtype=torch.int32, device=x.device)
    return lm_outputs(cfg, params, x), caches


def lm_decode_step(cfg, params, tokens_t, caches):
    """tokens_t (B,1). Uses caches['index'] as the write position; the caller
    keeps index < max_len (the cache is written in place)."""
    x = embed(cfg, params.embed, as_tokens(params, tokens_t))
    x = _run_blocks(cfg, params, x, None, caches, mode="decode")
    caches = dict(caches, index=caches["index"] + 1)
    return lm_outputs(cfg, params, x), caches


def make_lm(cfg) -> ModelBundle:
    check_supported(cfg)
    return ModelBundle(
        cfg=cfg,
        init=lambda seed=0, device="cuda", dtype=None: LM(cfg, seed, device, dtype),
        forward=lambda params, batch: lm_forward(cfg, params, batch),
        init_cache=lambda batch, max_len, dtype=torch.bfloat16, device="cuda":
            lm_init_cache(cfg, batch, max_len, dtype, device),
        prefill=lambda params, batch, max_len=None, dtype=torch.bfloat16:
            lm_prefill(cfg, params, batch, max_len, dtype),
        decode_step=lambda params, tokens_t, caches:
            lm_decode_step(cfg, params, tokens_t, caches),
    )
