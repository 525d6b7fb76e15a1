"""Token embedding table (vocab padded to the TP degree) + logits head,
with gemma's embedding scale and gemma2's final logit softcap."""

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import dtype_of
from repro_torch.nn import init as inits
from repro_torch.sharding.ctx import constrain, is_dtensor
from repro_torch.sharding.param import ParamMaker


class Embed(nn.Module):
    """`table` (padded_vocab, d) and, unless `cfg.tie_embeddings`, `unembed`
    (d, padded_vocab): the JAX package's layout and names."""

    def __init__(self, cfg, *, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()
        v, d = cfg.padded_vocab, cfg.d_model
        mk = ParamMaker(self, gen, dtype, device)
        self.table = mk("table", (v, d), ("vocab", "embed"), inits.normal(1.0))
        if not cfg.tie_embeddings:
            self.unembed = mk("unembed", (d, v), ("embed", "vocab"), inits.fan_in())


def _lookup(table, tokens):
    """table[tokens]. On a DTensor table, each rank looks up the tokens
    that fall in its vocab slice (zeros elsewhere) and one all-reduce over
    the vocab's mesh dims sums the rows (``local_map``), a vocab-parallel
    embedding; the table is first gathered over any other mesh dim (FSDP).
    The rows keep the tokens' batch sharding."""
    if not is_dtensor(table):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.comm import grad_placements, mesh_index, shard_dims, sum_over

    mesh = table.device_mesh
    vdims = shard_dims(table.placements, 0)
    tab_pl = tuple(Shard(0) if i in vdims else Replicate() for i in range(mesh.ndim))
    if tuple(table.placements) != tab_pl:
        table = table.redistribute(mesh, tab_pl)
    tok_pl = None
    if is_dtensor(tokens):
        tok_pl = tuple(pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
                       for pl in tokens.placements)
        if tuple(tokens.placements) != tok_pl:
            tokens = tokens.redistribute(mesh, tok_pl)
    out_pl = tok_pl or (Replicate(),) * mesh.ndim

    def body(tab, tok):
        n = tab.shape[0]
        rel = tok - mesh_index(mesh, vdims) * n
        mine = ((rel >= 0) & (rel < n))[..., None].to(tab.dtype)
        return sum_over(F.embedding(rel.clamp(0, n - 1), tab) * mine, mesh, vdims)
    return local_map(body, out_placements=(out_pl,), in_placements=(tab_pl, tok_pl),
                     in_grad_placements=(grad_placements(tab_pl), tok_pl),
                     device_mesh=mesh)(table, tokens)


def embed(cfg, p, tokens, scale_by_dim=False):
    """The table's rows (``_lookup``)."""
    x = _lookup(p.table, tokens)
    if scale_by_dim:  # gemma convention, in the table's dtype as in the JAX package
        x = x * math.sqrt(cfg.d_model)
    return constrain(x.to(dtype_of(cfg.compute_dtype)), "act_batch", "act_seq", "act_embed")


def unembed(cfg, p, x, softcap=None):
    """x (B,S,d) -> fp32 logits (B,S,padded_vocab), capped to
    softcap * tanh(logits / softcap) in fp32 with `softcap`; then padded
    ids masked to -1e30. Tied embeddings read the table transposed (a view,
    not a copy). Without grad mode the cap runs in place: at gemma2's
    vocab a 4 x 4352 prefill's logits take 17.8 GB, and out of place the
    cap would hold three such buffers at once."""
    w = p.table.t() if cfg.tie_embeddings else p.unembed
    logits = (x @ w.to(x.dtype)).float()
    if softcap:
        if torch.is_grad_enabled() or is_dtensor(logits):   # a DTensor's may be partial
            logits = softcap * torch.tanh(logits / softcap)
        else:
            logits.div_(softcap).tanh_().mul_(softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        if is_dtensor(logits):   # vocab-sharded: masked out of place
            ok = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
            logits = torch.where(ok, logits, -1e30)
        else:
            logits[..., cfg.vocab_size:] = -1e30
    return constrain(logits, "act_batch", "act_seq", "act_vocab")
