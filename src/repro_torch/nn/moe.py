"""Mixture-of-Experts layer with capacity-based, gather-only dispatch.

Mirrors ``repro.nn.moe`` (``route`` and ``moe``), step for step:

  1. top-k routing per token, in fp32 (the router and its bias are fp32
     parameters even in a bf16 model): softmax scores (qwen3-moe), or
     sigmoid scores ranked with the non-gradient ``router_bias`` and
     renormalised (DeepSeek-V3); a Switch-style auxiliary loss;
  2. a stable argsort of the N*k expert assignments;
  3. each expert slot (e, c) gathers the c-th token routed to expert e;
     tokens past the capacity ``cap = ceil(N*k/E * capacity_factor)`` are
     dropped, as in the reference;
  4. a batched SwiGLU over all E experts (``torch.bmm`` over (E, cap, d));
  5. each (token, k) pair gathers its slot back, scaled by its gate.

Every shape is static (no ``nonzero``, boolean indexing or ``.item()``),
so a step can be captured in a CUDA graph. The top-k is a stable
descending sort: among equal scores the lower expert index comes first,
as ``jax.lax.top_k`` keeps it, on the CPU and on the card alike (the order
of ``torch.topk`` among ties is not specified).

The reference's expert-parallel path (``moe_ep``, a shard_map over a
mesh) comes with the sharding slice; the port has no mesh yet, so
``moe`` raises if it is asked for one with ``moe_impl == "ep"``.
"""

import math

import torch
from torch import nn

from repro_torch.nn import init as inits
from repro_torch.nn.mlp import ACTS


class MoE(nn.Module):
    """router (d, E) and router_bias (E,) in fp32 whatever `dtype` is; wi, wg
    (E, d, f), wo (E, f, d); with `cfg.n_shared_experts`, shared_wi,
    shared_wg (d, fs) and shared_wo (fs, d), fs = moe_d_ff * n_shared: the
    JAX package's layout and names. router_bias exists for sigmoid
    scores only, as in the reference."""

    def __init__(self, cfg, *, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()
        d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

        def mk(shape, init, dt=dtype):
            return nn.Parameter(init(gen, shape, dt, device), requires_grad=False)
        self.router = mk((d, e), inits.fan_in(), torch.float32)
        self.wi = mk((e, d, f), inits.fan_in(in_axes=(1,)))
        self.wg = mk((e, d, f), inits.fan_in(in_axes=(1,)))
        self.wo = mk((e, f, d), inits.fan_in(in_axes=(1,)))
        self.shared_wi = self.shared_wg = self.shared_wo = None
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            self.shared_wi = mk((d, fs), inits.fan_in())
            self.shared_wg = mk((d, fs), inits.fan_in())
            self.shared_wo = mk((fs, d), inits.fan_in())
        self.router_bias = (mk((e,), inits.zeros, torch.float32)
                            if cfg.router_score == "sigmoid" else None)


def top_k(scores, k):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg, p, xf):
    """xf (N, d) fp32 -> gates (N, k) fp32, idx (N, k) int64, aux loss (0-d fp32)."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = xf @ p.router.float()                              # (N, E) fp32
    if cfg.router_score == "sigmoid":
        scores = torch.sigmoid(logits)
        _, idx = top_k(scores + p.router_bias.float(), k)
        gates = torch.gather(scores, -1, idx)
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
        probs = scores / (scores.sum(-1, keepdim=True) + 1e-20)
    else:
        probs = torch.softmax(logits, dim=-1)
        gates, idx = top_k(probs, k)
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    # Switch-style load-balancing auxiliary loss; a token's k experts are
    # distinct, so its one-hot rows sum to a 0/1 row
    picked = torch.zeros_like(probs).scatter_add_(1, idx, torch.ones_like(gates))
    aux = e * torch.sum(picked.mean(0) * probs.mean(0)) * (1.0 / k)
    return gates, idx, aux


def capacity(cfg, n_tokens):
    """Slots an expert holds for a call over `n_tokens` tokens."""
    return int(math.ceil(n_tokens * cfg.num_experts_per_tok / cfg.num_experts
                         * cfg.capacity_factor))


def moe(cfg, p, x, act="silu", mesh=None):
    """x (B,S,d) -> (y (B,S,d), aux loss 0-d fp32)."""
    if mesh is not None and cfg.moe_impl == "ep":
        raise NotImplementedError("expert-parallel MoE (moe_ep, a shard_map over a mesh) "
                                  "is not ported yet: it comes with the sharding slice")
    b, s, d = x.shape
    n = b * s
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = capacity(cfg, n)
    dev, dt = x.device, x.dtype
    xflat = x.reshape(n, d)
    gates, idx, aux = route(cfg, p, xflat.float())

    flat_expert = idx.reshape(-1)                               # (N*k,)
    order = torch.argsort(flat_expert, stable=True)             # (N*k,)
    sorted_expert = flat_expert[order]
    experts = torch.arange(e, device=dev)
    start = torch.searchsorted(sorted_expert, experts)          # (E,)
    end = torch.searchsorted(sorted_expert, experts, right=True)
    pos_sorted = torch.arange(n * k, device=dev) - start[sorted_expert]   # rank in expert

    # --- dispatch: slot (e, c) gathers its token (gather-only) ---
    slot_e = experts[:, None].expand(e, cap).reshape(-1)        # (E*C,)
    slot_c = torch.arange(cap, device=dev).repeat(e)
    sorted_idx = start[slot_e] + slot_c
    valid = sorted_idx < end[slot_e]
    sorted_idx = sorted_idx.clamp(max=n * k - 1)
    slot_token = order[sorted_idx] // k                         # (E*C,)
    xb = (xflat[slot_token] * valid[:, None].to(dt)).reshape(e, cap, d)

    # --- per-expert SwiGLU over every expert ---
    h = ACTS[act](torch.bmm(xb, p.wi.to(dt))) * torch.bmm(xb, p.wg.to(dt))
    y = torch.bmm(h, p.wo.to(dt)).reshape(e * cap, d)

    # --- combine: each (token, k) gathers its slot ---
    inv = torch.argsort(order, stable=True)                     # flat -> sorted pos
    pos_k = pos_sorted[inv]                                     # (N*k,)
    keep = (pos_k < cap).to(dt)
    slot_of = (flat_expert * cap + pos_k).clamp(max=e * cap - 1)
    yk = y[slot_of] * keep[:, None]                             # (N*k, d)
    out = torch.sum(yk.reshape(n, k, d) * gates[..., None].to(dt), dim=1)

    if p.shared_wi is not None:
        hs = ACTS[act](xflat @ p.shared_wi.to(dt)) * (xflat @ p.shared_wg.to(dt))
        out = out + hs @ p.shared_wo.to(dt)
    return out.reshape(b, s, d), aux
