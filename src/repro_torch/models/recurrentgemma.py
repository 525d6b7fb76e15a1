"""RecurrentGemma (Griffin): RG-LRU recurrent blocks + local attention, 2:1.

Mirrors ``repro.models.recurrentgemma``. Pattern period 3: (rglru, rglru,
local-attn); 26 layers are 8 periods and 2 trailing recurrent layers. The
layers live in one ``nn.ModuleList`` in pattern order, run in a Python loop,
in place of the JAX package's ``lax.scan`` over stacked periods
(``convert.params_from_jax`` unstacks them). Decode state: per recurrent
layer an (h fp32 (B,W), conv (B,3,W)) pair; per attention layer a ring KV
cache of min(max_len, local_window) slots, so the state does not grow past
the window.
"""

import functools

import torch
from torch import nn

from repro_torch.device import dtype_of, resolve, seeded_generator
from repro_torch.models.common import (ModelBundle, ValueHead, as_tokens, lm_outputs,
                                      maybe_remat)
from repro_torch.nn.attention import Attention, attention, decode_attention, make_cache
from repro_torch.nn.embed import Embed, embed
from repro_torch.nn.mlp import MLP, mlp
from repro_torch.nn.norms import Norm, apply_norm
from repro_torch.nn.rglru import RGLRU, rglru_block, rglru_state_init
from repro_torch.sharding.ctx import constrain, distribute_cache


def check_supported(cfg):
    """Raise for what the JAX model reads and the port does not have yet."""
    missing = [what for what, on in (
        (f"norm {cfg.norm!r}", cfg.norm != "rmsnorm"),
        (f"block kinds {cfg.block_pattern}", set(cfg.block_pattern) - {"rglru", "local"}),
        ("qkv biases", cfg.qkv_bias),
        ("softcaps (gemma2 slice)", cfg.attn_softcap or cfg.final_softcap),
    ) if on]
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported yet: {', '.join(missing)}")


def layer_kinds(cfg):
    """The kind of every layer, in the order they run."""
    return [cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.num_layers)]


class Block(nn.Module):
    def __init__(self, cfg, kind, **kw):
        super().__init__()
        self.norm1 = Norm(cfg.d_model, gemma_scale=cfg.gemma_scale, **kw)
        self.norm2 = Norm(cfg.d_model, gemma_scale=cfg.gemma_scale, **kw)
        self.mix = RGLRU(cfg, **kw) if kind == "rglru" else Attention(cfg, **kw)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, **kw)


class RecurrentGemma(nn.Module):
    """Parameters of the hybrid LM, built directly in `dtype` on `device`
    from a seeded torch.Generator on that device."""

    def __init__(self, cfg, seed=0, device="cuda", dtype=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve(device)
        gen = seeded_generator(dev, seed)
        kw = dict(gen=gen, dtype=dtype_of(dtype or cfg.param_dtype), device=dev)
        self.embed = Embed(cfg, **kw)
        self.blocks = nn.ModuleList(Block(cfg, kind, **kw) for kind in layer_kinds(cfg))
        self.final_norm = Norm(cfg.d_model, gemma_scale=cfg.gemma_scale, **kw)
        self.value_head = ValueHead(cfg.d_model, **kw)

    @property
    def device(self):
        return self.embed.table.device


def _layer(cfg, p, kind, x, positions, state, decode, index):
    x = constrain(x, "act_batch", "act_res_seq", "act_embed")
    h = apply_norm(p.norm1, x, cfg.norm_eps, cfg.gemma_scale)
    if kind == "rglru":
        h0, conv = (None, None) if state is None else state
        y, new_state = rglru_block(cfg, p.mix, h, h0=h0, conv_state=conv, decode=decode)
    elif decode:
        y, new_state = decode_attention(cfg, p.mix, h, index, state, kind="local")
    else:
        y, new_state = attention(cfg, p.mix, h, positions, kind="local", cache=state)
    x = x + y
    h = apply_norm(p.norm2, x, cfg.norm_eps, cfg.gemma_scale)
    return x + mlp(p.mlp, h, cfg.act), new_state


def _run(cfg, params, x, positions, caches=None, decode=False, remat="none"):
    """The layer stack. Returns (x, the new state of each layer or None)."""
    index = caches["index"] if decode else None
    layer = maybe_remat(functools.partial(_layer, cfg), remat)
    new_states = []
    for i, (kind, p) in enumerate(zip(layer_kinds(cfg), params.blocks)):
        st = None if caches is None else caches["layers"][i]
        x, ns = layer(p, kind, x, positions, st, decode, index)
        new_states.append(ns)
    return x, (None if caches is None else new_states)


def rg_forward(cfg, params, batch):
    x = embed(cfg, params.embed, as_tokens(params, batch["tokens"]), cfg.embed_scale)
    x, _ = _run(cfg, params, x, torch.arange(x.shape[1], device=x.device), remat=cfg.remat)
    return lm_outputs(cfg, params, x)


def rg_init_cache(cfg, batch, max_len, dtype=torch.bfloat16, device="cuda"):
    """{'layers': per layer an (h, conv) pair or a ring cache dict, 'index':
    0-d int32 tensor}."""
    dev = resolve(device)
    layers = [rglru_state_init(cfg, batch, dtype, dev) if kind == "rglru"
              else make_cache(cfg, batch, max_len, "local", dtype, dev)
              for kind in layer_kinds(cfg)]
    return distribute_cache({"layers": layers,
                             "index": torch.zeros((), dtype=torch.int32, device=dev)})


def rg_prefill(cfg, params, batch, max_len, dtype=torch.bfloat16):
    if max_len is None:
        raise ValueError("prefill needs max_len: it sizes the local layers' ring caches")
    x = embed(cfg, params.embed, as_tokens(params, batch["tokens"]), cfg.embed_scale)
    s = x.shape[1]
    caches = rg_init_cache(cfg, x.shape[0], max_len, dtype, params.device)
    x, states = _run(cfg, params, x, torch.arange(s, device=x.device), caches)
    caches = {"layers": states, "index": torch.full((), s, dtype=torch.int32, device=x.device)}
    return lm_outputs(cfg, params, x), caches


def rg_decode_step(cfg, params, tokens_t, caches):
    """tokens_t (B,1). The ring caches are written in place."""
    x = embed(cfg, params.embed, as_tokens(params, tokens_t), cfg.embed_scale)
    x, states = _run(cfg, params, x, None, caches, decode=True)
    return lm_outputs(cfg, params, x), {"layers": states, "index": caches["index"] + 1}


def make_recurrentgemma(cfg) -> ModelBundle:
    check_supported(cfg)
    return ModelBundle(
        cfg=cfg,
        init=lambda seed=0, device="cuda", dtype=None: RecurrentGemma(cfg, seed, device, dtype),
        forward=lambda params, batch: rg_forward(cfg, params, batch),
        init_cache=lambda batch, max_len, dtype=torch.bfloat16, device="cuda":
            rg_init_cache(cfg, batch, max_len, dtype, device),
        prefill=lambda params, batch, max_len=None, dtype=torch.bfloat16:
            rg_prefill(cfg, params, batch, max_len, dtype),
        decode_step=lambda params, tokens_t, caches:
            rg_decode_step(cfg, params, tokens_t, caches),
    )
