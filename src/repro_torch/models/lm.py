"""Decoder-only LM, the dense family: qwen3, gemma2 (local/global layers,
softcaps, sandwich norms, gemma norms and embeddings, tied embeddings),
starcoder2 (layernorm, qkv and MLP biases), qwen2.5 (qkv biases) and the
internvl2 backbone (the modality frontend's projection), with the R2D2 q
head.

Mirrors ``repro.models.lm``. Layer i has attention kind
``attn_pattern[i % period]`` (a local layer attends over ``local_window``
positions and keeps a ring cache of that many slots). Blocks live in an
``nn.ModuleList`` in the order they run, in a Python loop; this replaces
the JAX package's ``lax.scan`` over stacked pattern periods
(``convert.params_from_jax`` unstacks them). MoE, MLA, MTP, DeepSeek's
first dense layers and padded heads raise NotImplementedError until their
slices land.
"""

import functools

import torch
from torch import nn

from repro_torch.device import dtype_of, resolve
from repro_torch.models.common import (FrontendProj, ModelBundle, QHead, ValueHead,
                                      as_tokens, lm_outputs, maybe_remat)
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
        ("first dense layers", cfg.first_dense_layers),
        ("padded heads (tp > 1)", cfg.padded_heads != cfg.num_heads),
        (f"activation {cfg.act!r}", cfg.act not in ACTS),
    ) if on]
    if cfg.family != "dense" or missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {', '.join(missing) or cfg.family}")


def layer_kinds(cfg):
    """The attention kind of every layer, in the order they run."""
    period = len(cfg.attn_pattern)
    if cfg.num_layers % period:
        raise ValueError(f"{cfg.name}: layers {cfg.num_layers} not divisible by "
                         f"pattern period {period}")
    return [cfg.attn_pattern[i % period] for i in range(cfg.num_layers)]


class Block(nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        norm = functools.partial(Norm, cfg.d_model, kind=cfg.norm,
                                 gemma_scale=cfg.gemma_scale, **kw)
        self.norm1 = norm()
        self.norm2 = norm()
        self.attn = Attention(cfg, **kw)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, bias=cfg.mlp_bias, **kw)
        # gemma2's sandwich norms, on the attention's and the MLP's outputs
        self.post1 = norm() if cfg.post_block_norm else None
        self.post2 = norm() if cfg.post_block_norm else None


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
        self.frontend = FrontendProj(cfg, **kw) if cfg.frontend_tokens else None
        self.blocks = nn.ModuleList(Block(cfg, **kw) for _ in layer_kinds(cfg))
        self.final_norm = Norm(cfg.d_model, kind=cfg.norm, gemma_scale=cfg.gemma_scale, **kw)
        self.value_head = ValueHead(cfg.d_model, **kw)
        self.q_head = (QHead(cfg.d_model, cfg.num_actions, **kw)
                       if cfg.algo == "r2d2" and cfg.num_actions else None)

    @property
    def device(self):
        return self.embed.table.device


def _block(cfg, p, kind, x, positions, cache=None, decode=False, index=None):
    """One transformer block. Returns (x, new_cache)."""
    h = apply_norm(p.norm1, x, cfg.norm_eps, cfg.gemma_scale)
    if decode:
        y, new_cache = decode_attention(cfg, p.attn, h, index, cache, kind=kind)
    else:
        y, new_cache = attention(cfg, p.attn, h, positions, kind=kind, cache=cache)
    if p.post1 is not None:
        y = apply_norm(p.post1, y, cfg.norm_eps, cfg.gemma_scale)
    x = x + y
    h = apply_norm(p.norm2, x, cfg.norm_eps, cfg.gemma_scale)
    y = mlp(p.ffn, h, cfg.act)
    if p.post2 is not None:
        y = apply_norm(p.post2, y, cfg.norm_eps, cfg.gemma_scale)
    return x + y, new_cache


def _run_blocks(cfg, params, x, positions, caches=None, mode="train"):
    decode = mode == "decode"
    index = caches["index"] if decode else None
    block = maybe_remat(functools.partial(_block, cfg), cfg.remat if mode == "train" else "none")
    for i, (kind, p) in enumerate(zip(layer_kinds(cfg), params.blocks)):
        c = None if caches is None else caches["layers"][i]
        x, _ = block(p, kind, x, positions, c, decode, index)
    return x


def _embed_inputs(cfg, params, batch):
    """Token embeddings, after the frontend's projected embeddings (B,F,d)
    when the model has a frontend and the batch a "frontend" (B,F,fdim)."""
    x = embed(cfg, params.embed, as_tokens(params, batch["tokens"]), cfg.embed_scale)
    f = batch.get("frontend")
    if params.frontend is not None and f is not None:
        f = torch.as_tensor(f, device=params.device).to(x.dtype)
        x = torch.cat([f @ params.frontend.w.to(x.dtype), x], dim=1)
    return x


def lm_forward(cfg, params, batch):
    x = _embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    return lm_outputs(cfg, params, _run_blocks(cfg, params, x, positions))


def lm_init_cache(cfg, batch, max_len, dtype=torch.bfloat16, device="cuda"):
    """{'layers': one cache entry per layer (a ring of min(max_len, window)
    slots for a local layer), 'index': 0-d int32 tensor}."""
    dev = resolve(device)
    return {"layers": [make_cache(cfg, batch, max_len, kind, dtype, dev)
                       for kind in layer_kinds(cfg)],
            "index": torch.zeros((), dtype=torch.int32, device=dev)}


def lm_prefill(cfg, params, batch, max_len, dtype=torch.bfloat16):
    x = _embed_inputs(cfg, params, batch)
    b, s = x.shape[:2]
    if max_len is None or s > max_len:
        raise ValueError(f"prompt of {s} positions needs max_len >= {s}, got {max_len}")
    caches = lm_init_cache(cfg, b, max_len, dtype, params.device)
    positions = torch.arange(s, device=x.device)
    x = _run_blocks(cfg, params, x, positions, caches, mode="prefill")
    caches["index"] = torch.full((), s, dtype=torch.int32, device=x.device)
    return lm_outputs(cfg, params, x), caches


def lm_decode_step(cfg, params, tokens_t, caches):
    """tokens_t (B,1). Uses caches['index'] as the write position; the caller
    keeps index < max_len (the cache is written in place)."""
    x = embed(cfg, params.embed, as_tokens(params, tokens_t), cfg.embed_scale)
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
