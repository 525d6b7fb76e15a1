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

Expert parallelism (``moe_ep``, the reference's ``shard_map`` body as a
``local_map`` body over a ``DeviceMesh``): ``moe`` takes it under a
sharding context when ``cfg.moe_impl == "ep"`` and the activations are
DTensors. Each rank routes its local tokens (all-gathered over the data
axes that are also expert axes), dispatches them to its own expert slice
with the per-shard capacity, and one all-reduce over the expert axes sums
the partial outputs; the shared experts run column- and row-parallel over
'model' on the local tokens.
"""

import contextlib
import math
from types import SimpleNamespace

import torch
from torch import nn

from repro_torch.nn import init as inits
from repro_torch.nn.mlp import ACTS
from repro_torch.sharding.ctx import constrain, current, is_dtensor
from repro_torch.sharding.param import ParamMaker


class MoE(nn.Module):
    """router (d, E) and router_bias (E,) in fp32 whatever `dtype` is; wi, wg
    (E, d, f), wo (E, f, d); with `cfg.n_shared_experts`, shared_wi,
    shared_wg (d, fs) and shared_wo (fs, d), fs = moe_d_ff * n_shared: the
    JAX package's layout and names. router_bias exists for sigmoid
    scores only, as in the reference."""

    def __init__(self, cfg, *, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()
        d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

        mk = ParamMaker(self, gen, dtype, device)
        self.router = mk("router", (d, e), ("embed", "experts"), inits.fan_in(),
                         dtype=torch.float32)
        self.wi = mk("wi", (e, d, f), ("experts", "embed", "expert_mlp"),
                     inits.fan_in(in_axes=(1,)))
        self.wg = mk("wg", (e, d, f), ("experts", "embed", "expert_mlp"),
                     inits.fan_in(in_axes=(1,)))
        self.wo = mk("wo", (e, f, d), ("experts", "expert_mlp", "embed"),
                     inits.fan_in(in_axes=(1,)))
        self.shared_wi = self.shared_wg = self.shared_wo = None
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            self.shared_wi = mk("shared_wi", (d, fs), ("embed", "mlp"), inits.fan_in())
            self.shared_wg = mk("shared_wg", (d, fs), ("embed", "mlp"), inits.fan_in())
            self.shared_wo = mk("shared_wo", (fs, d), ("mlp", "embed"), inits.fan_in())
        self.router_bias = (mk("router_bias", (e,), ("experts",), inits.zeros,
                               dtype=torch.float32)
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


@contextlib.contextmanager
def expert_choices(replay=None):
    """Each MoE call's routing inside the block, in call order, for
    comparing two runs only (``route`` or ``top_k`` wrapped while it runs).
    A near tie in a router's top-k that another rounding breaks the other
    way sends a token to another expert, which moves that expert's output
    and gradients by a token's share.

    Without `replay`, yields a list that gets a dict a call: its expert ids
    "idx" (N, k), its capacity "cap" and "dropped", the (token, k) pairs
    past capacity (a tensor on the ids' device): an expert keeps its first
    `cap` pairs in the stable order, so it drops max(0, pairs - cap). With
    `replay`, such a list of another run, each call takes the ids recorded
    there in place of its own top-k, with its own scores at those ids (the
    same routing, hence the same drops), and the yielded dict counts the
    "calls" and the (token, k) choices "changed" from its own top-k."""
    this = globals()
    real_route, real_top_k = route, top_k
    calls, replayed = [], {"calls": 0, "changed": 0}

    def recorded(cfg, p, xf):
        gates, idx, aux = real_route(cfg, p, xf)
        cap = capacity(cfg, xf.shape[0])
        load = torch.zeros(cfg.num_experts, dtype=torch.long, device=idx.device)
        load.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))
        calls.append({"idx": idx, "cap": cap, "dropped": (load - cap).clamp(min=0).sum()})
        return gates, idx, aux

    def forced(scores, k):
        idx = next(ids)
        own = real_top_k(scores, k)[1]
        replayed["calls"] += 1
        replayed["changed"] += int((own[..., :, None] != idx[..., None, :]).all(-1).sum())
        return torch.gather(scores, -1, idx), idx

    if replay is None:
        this["route"] = recorded
    else:
        ids = iter([r["idx"] for r in replay])
        this["top_k"] = forced
    try:
        yield calls if replay is None else replayed
    finally:
        this["route"], this["top_k"] = real_route, real_top_k


def _local_dispatch_ffn(cfg, p, xflat, gates, idx, e0, e_local, cap, act, dt,
                        slots=lambda t: t):
    """Capacity dispatch and FFN for the experts [e0, e0 + e_local) that this
    rank holds, over its routed tokens: local compute only, returning the
    partial output (n, d) that the caller sums over the ranks (with e0 0
    and e_local E, the whole layer's routed output). Pairs routed to
    another rank's experts sort last and are dropped here. `slots` maps
    the (e_local, cap, d) slot tensors (dispatched tokens, expert outputs):
    ``moe``'s sharding constraint."""
    n = xflat.shape[0]
    k = cfg.num_experts_per_tok
    dev = xflat.device
    flat_expert = idx.reshape(-1)                               # (n*k,)
    mine = None
    if e_local < cfg.num_experts:   # another rank's pairs: index e_local, sorted last
        local = flat_expert - e0
        mine = (local >= 0) & (local < e_local)
        flat_expert = torch.where(mine, local, e_local)
    order = torch.argsort(flat_expert, stable=True)             # (n*k,)
    sorted_expert = flat_expert[order]
    bounds = torch.arange(e_local + 1, device=dev)
    start = torch.searchsorted(sorted_expert, bounds)           # (e_local + 1,)
    experts = bounds[:e_local]
    end = torch.searchsorted(sorted_expert, experts, right=True)
    pos_sorted = torch.arange(n * k, device=dev) - start[sorted_expert]   # rank in expert

    # --- dispatch: slot (e, c) gathers its token (gather-only) ---
    slot_e = experts[:, None].expand(e_local, cap).reshape(-1)  # (e_local*cap,)
    slot_c = torch.arange(cap, device=dev).repeat(e_local)
    sorted_idx = start[slot_e] + slot_c
    valid = sorted_idx < end[slot_e]
    sorted_idx = sorted_idx.clamp(max=n * k - 1)
    slot_token = order[sorted_idx] // k
    xb = slots((xflat[slot_token] * valid[:, None].to(dt)).reshape(e_local, cap, -1))

    # --- per-expert FFN over this rank's experts ---
    h = ACTS[act](torch.bmm(xb, p.wi.to(dt))) * torch.bmm(xb, p.wg.to(dt))
    y = slots(torch.bmm(h, p.wo.to(dt))).reshape(e_local * cap, -1)

    # --- combine: each (token, k) gathers its slot ---
    inv = torch.argsort(order, stable=True)                     # flat -> sorted pos
    pos_k = pos_sorted[inv]
    keep = pos_k < cap
    if mine is not None:
        keep = keep & mine
    slot_of = (flat_expert * cap + pos_k).clamp(max=e_local * cap - 1)
    yk = y[slot_of] * keep.to(dt)[:, None]                      # (n*k, d)
    return torch.sum(yk.reshape(n, k, -1) * gates.reshape(n, k, 1).to(dt), dim=1)


def ep_layout(cfg, mesh, rules):
    """(dp_axes, ep_axes, gather_axes) of ``moe_ep`` on `mesh`: the batch's
    data axes; the expert axes from the rules' 'experts' entry, each kept
    while the expert count divides ('model' for training, ('model',
    'data') for serving: "full EP"); the expert axes that are also data
    axes, over which each rank gathers the tokens it routes."""
    from repro_torch.sharding.rules import mesh_axes, mesh_sizes
    names, sizes = mesh_axes(mesh), mesh_sizes(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in names)
    ep_axes, tot = [], 1
    for a in rules.get("experts", ("model",)):
        if a in names and cfg.num_experts % (tot * sizes[a]) == 0:
            ep_axes.append(a)
            tot *= sizes[a]
    ep_axes = tuple(ep_axes) or tuple(a for a in ("model",) if a in names)
    return dp_axes, ep_axes, tuple(a for a in ep_axes if a in dp_axes)


def moe_ep(cfg, p, x, act="silu"):
    """Expert-parallel MoE over the current sharding context's mesh, as a
    ``local_map`` body (the reference's ``shard_map``): x (B,S,d) a DTensor
    -> (y (B,S,d) with x's batch sharding, aux loss 0-d fp32 replicated).
    The capacity is the reference's per-shard one, ceil(n_routed * k / E *
    capacity_factor) over the n_routed tokens a rank routes."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.comm import (gather_over, grad_placements, mesh_index,
                                           scatter_sum_over, sum_over)
    from repro_torch.sharding.rules import mesh_axes

    mesh, rules = current()
    names = mesh_axes(mesh)
    dp_axes, ep_axes, gather_axes = ep_layout(cfg, mesh, rules)
    dim = {a: i for i, a in enumerate(names)}
    size = lambda axes: math.prod(mesh.size(dim[a]) for a in axes)   # noqa: E731
    b, s, d = x.shape
    e = cfg.num_experts
    e_local = e // size(ep_axes)
    n_local = (b * s) // size(dp_axes)
    cap = int(math.ceil(n_local * size(gather_axes) * cfg.num_experts_per_tok / e
                        * cfg.capacity_factor))
    dt = x.dtype

    def on(axes, d_):
        return tuple(Shard(d_) if a in axes else Replicate() for a in names)
    rep = on((), 0)
    x_pl, w_pl = on(dp_axes, 0), on(ep_axes, 0)
    has_shared = p.shared_wi is not None
    model = ("model",) if "model" in names else ()
    args = [x, p.router, p.router_bias, p.wi, p.wg, p.wo]
    in_pl = [x_pl, rep, rep, w_pl, w_pl, w_pl]
    if has_shared:
        args += [p.shared_wi, p.shared_wg, p.shared_wo]
        in_pl += [on(model, 1), on(model, 1), on(model, 0)]
    args = [a if a is None or tuple(a.placements) == pl else a.redistribute(mesh, pl)
            for a, pl in zip(args, in_pl)]
    in_pl = [None if a is None else pl for a, pl in zip(args, in_pl)]
    ep_dims = [dim[a] for a in names if a in ep_axes]          # mesh order, major first
    gather_dims = [dim[a] for a in names if a in gather_axes]

    def body(xl, router, router_bias, wi, wg, wo, *shared):
        bl, sl, _ = xl.shape
        xflat = xl.reshape(bl * sl, d)
        routed = gather_over(xflat, mesh, gather_dims)
        gates, idx, aux = route(cfg, SimpleNamespace(router=router, router_bias=router_bias),
                                routed.float())
        y = _local_dispatch_ffn(cfg, SimpleNamespace(wi=wi, wg=wg, wo=wo), routed, gates, idx,
                                mesh_index(mesh, ep_dims) * e_local, e_local, cap, act, dt)
        sh = None
        if shared:                           # local tokens, tensor-parallel over 'model'
            swi, swg, swo = shared
            sh = (ACTS[act](xflat @ swi.to(dt)) * (xflat @ swg.to(dt))) @ swo.to(dt)
        if gather_dims:
            # each rank's own tokens back, summed over the expert ranks
            y = scatter_sum_over(y, mesh, gather_dims)
            y = sum_over(y, mesh, [m for m in ep_dims if m not in gather_dims])
            if sh is not None:
                y = y + sum_over(sh, mesh, [dim[a] for a in model])
        else:
            y = sum_over(y + sh if sh is not None else y, mesh, ep_dims)
        mean_dims = [dim[a] for a in ep_axes + tuple(a for a in dp_axes if a not in ep_axes)]
        aux = sum_over(aux, mesh, mean_dims) / math.prod(mesh.size(m) for m in mean_dims)
        return y.reshape(bl, sl, d), aux

    # a replicated input's gradient is partial on each rank (each computes
    # with it on its own tokens or experts); a sharded one's stays sharded
    grad_pl = tuple(None if pl is None else grad_placements(pl) for pl in in_pl)
    return local_map(body, out_placements=(x_pl, rep), in_placements=tuple(in_pl),
                     in_grad_placements=grad_pl, device_mesh=mesh)(*args)


def moe(cfg, p, x, act="silu"):
    """x (B,S,d) -> (y (B,S,d), aux loss 0-d fp32). Under a sharding context,
    on DTensors with ``cfg.moe_impl == "ep"``, the expert-parallel path
    (``moe_ep``); otherwise the gather-only dispatch over every expert."""
    if cfg.moe_impl == "ep" and current() is not None and is_dtensor(x):
        return moe_ep(cfg, p, x, act)
    b, s, d = x.shape
    dt = x.dtype
    xflat = x.reshape(b * s, d)
    gates, idx, aux = route(cfg, p, xflat.float())
    out = _local_dispatch_ffn(cfg, p, xflat, gates, idx, 0, cfg.num_experts,
                              capacity(cfg, b * s), act, dt,
                              slots=lambda t: constrain(t, "act_experts", None, None))
    if p.shared_wi is not None:
        hs = ACTS[act](xflat @ p.shared_wi.to(dt)) * (xflat @ p.shared_wg.to(dt))
        out = out + hs @ p.shared_wo.to(dt)
    return out.reshape(b, s, d), aux
