"""Mamba2 (SSD) language model — attention-free, O(S) decode state.

Mirrors ``repro.models.mamba``: a uniform stack of SSD blocks (pre-norm
residual). Blocks live in an ``nn.ModuleList`` and run in a Python loop in
place of the JAX package's ``lax.scan`` over stacked parameters
(``convert.params_from_jax`` unstacks them). Decode carries a per-layer
(ssm_state, conv_state) instead of a KV cache, so the cache does not grow
with the sequence and ``max_len`` is accepted and ignored.
"""

import functools

import torch
from torch import nn

from repro_torch.device import dtype_of, resolve, seeded_generator
from repro_torch.models.common import (ModelBundle, ValueHead, as_tokens, lm_outputs,
                                      maybe_remat)
from repro_torch.nn.embed import Embed, embed
from repro_torch.nn.norms import Norm, apply_norm
from repro_torch.nn.ssd import SSD, ssd_layer, ssd_state_init
from repro_torch.sharding.ctx import constrain, distribute_cache


def check_supported(cfg):
    """Raise for what the JAX Mamba reads and the port does not have yet."""
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"{cfg.name}: not ported yet: {cfg.norm}")


class Block(nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        self.norm = Norm(cfg.d_model, **kw)
        self.ssd = SSD(cfg, **kw)


class Mamba(nn.Module):
    """Parameters of the Mamba2 LM, built directly in `dtype` on `device`
    from a seeded torch.Generator on that device."""

    def __init__(self, cfg, seed=0, device="cuda", dtype=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve(device)
        gen = seeded_generator(dev, seed)
        kw = dict(gen=gen, dtype=dtype_of(dtype or cfg.param_dtype), device=dev)
        self.embed = Embed(cfg, **kw)
        self.blocks = nn.ModuleList(Block(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_norm = Norm(cfg.d_model, **kw)
        self.value_head = ValueHead(cfg.d_model, **kw)

    @property
    def device(self):
        return self.embed.table.device


def _layer(cfg, p, x, state, conv_state, decode):
    x = constrain(x, "act_batch", "act_res_seq", "act_embed")
    y, st = ssd_layer(cfg, p.ssd, apply_norm(p.norm, x, cfg.norm_eps), state=state,
                      conv_state=conv_state, decode=decode)
    return x + y, st


def _run(cfg, params, x, states=None, decode=False, remat="none"):
    """The block stack. Returns (x, the new (ssm_state, conv_state) of each
    layer); without `states`, prefill starts from zeros and keeps no conv
    state."""
    layer = maybe_remat(functools.partial(_layer, cfg), remat)
    new_states = []
    for i, p in enumerate(params.blocks):
        state, conv_state = (None, None) if states is None else states[i]
        x, st = layer(p, x, state, conv_state, decode)
        new_states.append(st)
    return x, new_states


def mamba_forward(cfg, params, batch):
    x = embed(cfg, params.embed, as_tokens(params, batch["tokens"]))
    x, _ = _run(cfg, params, x, remat=cfg.remat)
    return lm_outputs(cfg, params, x)


def mamba_init_cache(cfg, batch, max_len=None, dtype=torch.bfloat16, device="cuda"):
    """{'layers': [(ssm_state fp32 (B,H,P,N), conv_state (B,W-1,C) in
    `dtype`)] per layer, 'index': 0-d int32 tensor}. `max_len` is ignored:
    the state does not grow with the sequence."""
    del max_len
    dev = resolve(device)
    return distribute_cache({
        "layers": [ssd_state_init(cfg, batch, dtype, dev) for _ in range(cfg.num_layers)],
        "index": torch.zeros((), dtype=torch.int32, device=dev)})


def mamba_prefill(cfg, params, batch, max_len=None, dtype=torch.bfloat16):
    x = embed(cfg, params.embed, as_tokens(params, batch["tokens"]))
    cache = mamba_init_cache(cfg, x.shape[0], dtype=dtype, device=params.device)
    x, states = _run(cfg, params, x, states=cache["layers"])
    cache = {"layers": states,
             "index": torch.full((), x.shape[1], dtype=torch.int32, device=x.device)}
    return lm_outputs(cfg, params, x), cache


def mamba_decode_step(cfg, params, tokens_t, cache):
    x = embed(cfg, params.embed, as_tokens(params, tokens_t))
    x, states = _run(cfg, params, x, states=cache["layers"], decode=True)
    return lm_outputs(cfg, params, x), {"layers": states, "index": cache["index"] + 1}


def make_mamba(cfg) -> ModelBundle:
    check_supported(cfg)
    return ModelBundle(
        cfg=cfg,
        init=lambda seed=0, device="cuda", dtype=None: Mamba(cfg, seed, device, dtype),
        forward=lambda params, batch: mamba_forward(cfg, params, batch),
        init_cache=lambda batch, max_len=None, dtype=torch.bfloat16, device="cuda":
            mamba_init_cache(cfg, batch, max_len, dtype, device),
        prefill=lambda params, batch, max_len=None, dtype=torch.bfloat16:
            mamba_prefill(cfg, params, batch, max_len, dtype),
        decode_step=lambda params, tokens_t, cache:
            mamba_decode_step(cfg, params, tokens_t, cache),
    )
