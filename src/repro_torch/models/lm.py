"""Decoder-only LM: the dense family (qwen3, gemma2 with local/global
layers, softcaps, sandwich norms, gemma norms and embeddings and tied
embeddings, starcoder2 with layernorm and biases, qwen2.5 with qkv biases,
the internvl2 backbone with the modality frontend's projection), MoE
(qwen3-moe) and MLA with MoE, DeepSeek's first dense layers and its MTP
head (deepseek-v3), with the R2D2 q head.

Mirrors ``repro.models.lm``. Layers run in the reference's order: the
``first_dense_layers`` (global attention and a dense MLP) first, then the
main layers, layer j of which has attention kind ``attn_pattern[j %
period]`` (a local layer attends over ``local_window`` positions and keeps
a ring cache of that many slots) and an MoE in place of the MLP when the
family is "moe". ``layer_plan`` gives each layer's kind, MoE-ness and
place in the reference's stacked params; the model, the cache and
``convert.params_from_jax`` all read it. Blocks live in an
``nn.ModuleList`` in that order, run by a Python loop; this replaces the
JAX package's ``lax.scan`` over the stacked ``pre`` and ``main`` periods.
With ``cfg.mla`` every attention is MLA (``nn/mla.py``). The MTP head
(one more block on [norm(h_t); embed(token t+1)], predicting token t+2)
runs in ``forward`` only, as the reference's. With tp > 1 the attention
holds ``cfg.padded_heads`` query heads (``nn/attention.py``) and the vocab
is padded to a multiple of 256. Under a sharding context the residual
stream and the norms' outputs are constrained where the reference's are,
and the cache is made of DTensors with ``cache_leaf_axes``' placements.
"""

import functools
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.device import dtype_of, resolve, seeded_generator
from repro_torch.models.common import (FrontendProj, ModelBundle, QHead, ValueHead,
                                      as_tokens, lm_outputs, maybe_remat)
from repro_torch.nn import init as inits
from repro_torch.nn.attention import (Attention, attention, decode_attention,
                                      make_cache)
from repro_torch.nn.embed import Embed, embed, unembed
from repro_torch.nn.mla import MLA, make_mla_cache, mla_attention, mla_decode
from repro_torch.nn.mlp import ACTS, MLP, mlp
from repro_torch.nn.moe import MoE, moe
from repro_torch.nn.norms import Norm, apply_norm
from repro_torch.sharding.ctx import constrain, distribute_cache
from repro_torch.sharding.param import ParamMaker


def check_supported(cfg):
    """Raise for the parts of the JAX LM that are not ported yet."""
    missing = [f"activation {cfg.act!r}"] if cfg.act not in ACTS else []
    if cfg.family not in ("dense", "moe") or missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {', '.join(missing) or cfg.family}")


class LayerSpec(NamedTuple):
    kind: str       # attention kind: "global" or "local"
    moe: bool       # an MoE in place of the dense MLP
    stack: str      # the reference's stacked params holding it: "pre.p0" or "main.p{k}"
    leaf: int       # its index along that stack's layer axis


def layer_plan(cfg):
    """Every layer in the order they run: DeepSeek's first dense layers
    (the reference's stack "pre"), then the main layers, period by period."""
    period, k_pre = len(cfg.attn_pattern), cfg.first_dense_layers
    if (cfg.num_layers - k_pre) % period:
        raise ValueError(f"{cfg.name}: layers {cfg.num_layers} not divisible by "
                         f"pattern period {period}")
    pre = [LayerSpec("global", False, "pre.p0", j) for j in range(k_pre)]
    return pre + [LayerSpec(cfg.attn_pattern[j % period], cfg.family == "moe",
                            f"main.p{j % period}", j // period)
                  for j in range(cfg.num_layers - k_pre)]


def layer_kinds(cfg):
    """The attention kind of every layer, in the order they run."""
    return [spec.kind for spec in layer_plan(cfg)]


class Block(nn.Module):
    def __init__(self, cfg, moe_layer=False, **kw):
        super().__init__()
        norm = functools.partial(Norm, cfg.d_model, kind=cfg.norm,
                                 gemma_scale=cfg.gemma_scale, **kw)
        self.norm1 = norm()
        self.norm2 = norm()
        self.attn = MLA(cfg, **kw) if cfg.mla else Attention(cfg, **kw)
        self.ffn = MoE(cfg, **kw) if moe_layer else MLP(cfg.d_model, cfg.d_ff,
                                                         bias=cfg.mlp_bias, **kw)
        # gemma2's sandwich norms, on the attention's and the MLP's outputs
        self.post1 = norm() if cfg.post_block_norm else None
        self.post2 = norm() if cfg.post_block_norm else None


class MTP(nn.Module):
    """proj (2d, d), norm, and one block (MoE when the family is): the
    reference's "mtp" params."""

    def __init__(self, cfg, *, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()
        d = cfg.d_model
        kw = dict(gen=gen, dtype=dtype, device=device)
        self.proj = ParamMaker(self, gen, dtype, device)(
            "proj", (2 * d, d), ("embed", "embed"), inits.fan_in())
        self.norm = Norm(d, kind=cfg.norm, **kw)
        self.block = Block(cfg, cfg.family == "moe", **kw)


class LM(nn.Module):
    """Parameters of the LM, built directly in `dtype` on `device` from a
    seeded torch.Generator on that device (an MoE's router in fp32)."""

    def __init__(self, cfg, seed=0, device="cuda", dtype=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve(device)
        gen = seeded_generator(dev, seed)
        kw = dict(gen=gen, dtype=dtype_of(dtype or cfg.param_dtype), device=dev)
        self.embed = Embed(cfg, **kw)
        self.frontend = FrontendProj(cfg, **kw) if cfg.frontend_tokens else None
        self.blocks = nn.ModuleList(Block(cfg, spec.moe, **kw) for spec in layer_plan(cfg))
        self.final_norm = Norm(cfg.d_model, kind=cfg.norm, gemma_scale=cfg.gemma_scale, **kw)
        self.value_head = ValueHead(cfg.d_model, **kw)
        self.q_head = (QHead(cfg.d_model, cfg.num_actions, **kw)
                       if cfg.algo == "r2d2" and cfg.num_actions else None)
        self.mtp = MTP(cfg, **kw) if cfg.mtp_depth else None

    @property
    def device(self):
        return self.embed.table.device


def _block(cfg, p, kind, x, positions, cache=None, decode=False, index=None):
    """One transformer block. Returns (x, new_cache, aux), aux the MoE's
    router loss (0-d fp32) or None for a dense MLP."""
    x = constrain(x, "act_batch", "act_res_seq", "act_embed")
    h = apply_norm(p.norm1, x, cfg.norm_eps, cfg.gemma_scale)
    h = constrain(h, "act_batch", None, "act_embed")
    if cfg.mla:
        if decode:
            y, new_cache = mla_decode(cfg, p.attn, h, index, cache)
        else:
            y, new_cache = mla_attention(cfg, p.attn, h, positions, cache=cache)
    elif decode:
        y, new_cache = decode_attention(cfg, p.attn, h, index, cache, kind=kind)
    else:
        y, new_cache = attention(cfg, p.attn, h, positions, kind=kind, cache=cache)
    if p.post1 is not None:
        y = apply_norm(p.post1, y, cfg.norm_eps, cfg.gemma_scale)
    x = constrain(x + constrain(y, "act_batch", "act_res_seq", "act_embed"),
                  "act_batch", "act_res_seq", "act_embed")
    h = apply_norm(p.norm2, x, cfg.norm_eps, cfg.gemma_scale)
    h = constrain(h, "act_batch", None, "act_embed")
    aux = None
    if isinstance(p.ffn, MoE):
        y, aux = moe(cfg, p.ffn, h, cfg.act)
    else:
        y = mlp(p.ffn, h, cfg.act)
    if p.post2 is not None:
        y = apply_norm(p.post2, y, cfg.norm_eps, cfg.gemma_scale)
    return x + y, new_cache, aux


def _run_blocks(cfg, params, x, positions, caches=None, mode="train"):
    """Run every layer. Returns (x, aux), aux the router losses summed over
    the layers (0-d fp32, zero without MoE)."""
    decode = mode == "decode"
    index = caches["index"] if decode else None
    block = maybe_remat(functools.partial(_block, cfg), cfg.remat if mode == "train" else "none")
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (spec, p) in enumerate(zip(layer_plan(cfg), params.blocks)):
        c = None if caches is None else caches["layers"][i]
        x, _, aux = block(p, spec.kind, x, positions, c, decode, index)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def _embed_inputs(cfg, params, batch):
    """Token embeddings, after the frontend's projected embeddings (B,F,d)
    when the model has a frontend and the batch a "frontend" (B,F,fdim)."""
    x = embed(cfg, params.embed, as_tokens(params, batch["tokens"]), cfg.embed_scale)
    f = batch.get("frontend")
    if params.frontend is not None and f is not None:
        f = torch.as_tensor(f, device=params.device).to(x.dtype)
        x = torch.cat([f @ params.frontend.w.to(x.dtype), x], dim=1)
    return x


def _mtp_logits(cfg, params, batch, x, positions):
    """The MTP head: token t+2 predicted from (h_t, embed(token t+1)), the
    tokens rolled by one (the last position sees token 0), zeros before
    them where a frontend padded the sequence."""
    h = apply_norm(params.mtp.norm, x, cfg.norm_eps)
    nxt = torch.roll(as_tokens(params, batch["tokens"]), -1, dims=1)
    e = embed(cfg, params.embed, nxt, cfg.embed_scale)
    if e.shape[1] != x.shape[1]:   # frontend-padded sequence
        e = torch.cat([e.new_zeros((e.shape[0], x.shape[1] - e.shape[1], e.shape[2])), e],
                      dim=1)
    hm = torch.cat([h, e], dim=-1) @ params.mtp.proj.to(x.dtype)
    hm, _, _ = _block(cfg, params.mtp.block, "global", hm, positions)
    hm = apply_norm(params.final_norm, hm, cfg.norm_eps, cfg.gemma_scale)
    return unembed(cfg, params.embed, hm, softcap=cfg.final_softcap)


def lm_forward(cfg, params, batch):
    x = _embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _run_blocks(cfg, params, x, positions)
    mtp_logits = None
    if cfg.mtp_depth and params.mtp is not None:
        mtp_logits = _mtp_logits(cfg, params, batch, x, positions)
    return lm_outputs(cfg, params, x, aux, mtp_logits)


def lm_init_cache(cfg, batch, max_len, dtype=torch.bfloat16, device="cuda"):
    """{'layers': one cache entry per layer (MLA's compressed cache; a ring
    of min(max_len, window) slots for a local layer), 'index': 0-d int32
    tensor}."""
    dev = resolve(device)

    def entry(kind):
        if cfg.mla:
            return make_mla_cache(cfg, batch, max_len, dtype, dev)
        return make_cache(cfg, batch, max_len, kind, dtype, dev)
    return distribute_cache({"layers": [entry(kind) for kind in layer_kinds(cfg)],
                             "index": torch.zeros((), dtype=torch.int32, device=dev)})


def lm_prefill(cfg, params, batch, max_len, dtype=torch.bfloat16):
    x = _embed_inputs(cfg, params, batch)
    b, s = x.shape[:2]
    if max_len is None or s > max_len:
        raise ValueError(f"prompt of {s} positions needs max_len >= {s}, got {max_len}")
    caches = lm_init_cache(cfg, b, max_len, dtype, params.device)
    positions = torch.arange(s, device=x.device)
    x, aux = _run_blocks(cfg, params, x, positions, caches, mode="prefill")
    caches["index"] = torch.full((), s, dtype=torch.int32, device=x.device)
    return lm_outputs(cfg, params, x, aux), caches


def lm_decode_step(cfg, params, tokens_t, caches):
    """tokens_t (B,1). Uses caches['index'] as the write position; the caller
    keeps index < max_len (the cache is written in place)."""
    x = embed(cfg, params.embed, as_tokens(params, tokens_t), cfg.embed_scale)
    x, aux = _run_blocks(cfg, params, x, None, caches, mode="decode")
    caches = dict(caches, index=caches["index"] + 1)
    return lm_outputs(cfg, params, x, aux), caches


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
