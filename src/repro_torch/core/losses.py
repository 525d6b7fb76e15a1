"""Train-step builders: V-trace actor-critic (LM policies) and R2D2
(recurrent Q-learning, the paper's workload).

Mirrors ``repro.core.losses``. The train state is a dict {params,
opt_state, step[, target]}: params the family's ``nn.Module`` with its
parameters trainable, opt_state the optimizer's dicts keyed by parameter
name, step a Python int, target (R2D2) a second module with the params'
layout, never an alias of them. ``make_train_step`` returns a function
that updates the state in place under ``no_grad`` (the counterpart of the
JAX step's ``donate_argnums=(0,)``) and returns it with the step's metrics
as device tensors; it never waits on the device, so a caller that prints
a metric pays the sync there.
"""

import copy

import torch

from repro_torch.core.r2d2 import r2d2_loss
from repro_torch.core.vtrace import vtrace, vtrace_losses
from repro_torch.models.atari import atari_forward
from repro_torch.optim.adamw import apply_updates


def init_train_state(bundle, optimizer, seed=0, device="cuda", dtype=None, with_target=False):
    """Params built by ``bundle.init`` and made trainable (every parameter of
    the port is made with ``requires_grad=False``, as serving wants), the
    optimizer's state over them, and step 0; with `with_target`, a copy of
    the params in buffers of its own as the target net (R2D2)."""
    params = bundle.init(seed, device=device, dtype=dtype)
    params.requires_grad_(True)
    st = {"params": params, "opt_state": optimizer.init(dict(params.named_parameters())),
          "step": 0}
    if with_target:
        st["target"] = copy.deepcopy(params).requires_grad_(False)
    return st


def _token_logprobs_entropy(logits, actions):
    """logits (B,T,V) fp32, actions (B,T). Returns (logprob, entropy) (B,T).

    The action's logit is read with ``gather``: on one card it gives the
    same value as the reference's one-hot contraction, which exists so
    that GSPMD keeps vocab-sharded logits sharded, without building a
    (B,T,V) mask."""
    from repro_torch.sharding.ctx import is_dtensor
    if is_dtensor(logits):
        return _vocab_parallel_logprobs_entropy(logits, actions)
    lse = torch.logsumexp(logits, dim=-1)
    a_logit = torch.gather(logits, -1, actions[..., None].long())[..., 0]
    logprob = a_logit - lse
    # entropy = lse - E_p[logit]
    p = torch.softmax(logits, dim=-1)
    entropy = lse - torch.sum(p * logits, dim=-1)
    return logprob, entropy


def _vocab_parallel_logprobs_entropy(logits, actions):
    """`_token_logprobs_entropy` on DTensor logits whose vocab dim may be
    sharded: each rank works on its vocab slice (``local_map``) and
    all-reduces over the vocab's mesh dims the three sums that need the
    whole row (its action's logit, the exp-sum against the row max, the
    p-weighted logit sum), as a vocab-parallel cross-entropy does; the row
    max is a stabiliser with no gradient. (logprob, entropy) come out with
    the logits' batch sharding, replicated elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.comm import (grad_placements, max_over, mesh_index, shard_dims,
                                           sum_over)
    from repro_torch.sharding.ctx import is_dtensor

    mesh, lp = logits.device_mesh, tuple(logits.placements)
    vdims = shard_dims(lp, logits.ndim - 1)
    bp = tuple(pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate() for pl in lp)
    if any(isinstance(pl, Shard) and pl.dim not in (0, logits.ndim - 1) for pl in lp):
        raise NotImplementedError(f"token logprobs on logits placed {lp}")
    if not is_dtensor(actions):
        from repro_torch.sharding.param import shard_tensor
        actions = shard_tensor(actions, mesh, bp)
    elif tuple(actions.placements) != bp:
        actions = actions.redistribute(mesh, bp)

    def body(lg, act):
        v_local = lg.shape[-1]
        rel = act.long() - mesh_index(mesh, vdims) * v_local
        mine = (rel >= 0) & (rel < v_local)
        a_logit = torch.gather(lg, -1, rel.clamp(0, v_local - 1)[..., None])[..., 0]
        a_logit = sum_over(torch.where(mine, a_logit, 0.0), mesh, vdims)
        m = max_over(lg.detach().amax(-1), mesh, vdims)
        e = torch.exp(lg - m[..., None])
        lse = m + torch.log(sum_over(e.sum(-1), mesh, vdims))
        p = torch.exp(lg - lse[..., None])
        entropy = lse - sum_over(torch.sum(p * lg, dim=-1), mesh, vdims)
        return a_logit - lse, entropy

    return local_map(body, out_placements=(bp, bp), in_placements=(lp, bp),
                     in_grad_placements=(grad_placements(lp), bp),
                     device_mesh=mesh)(logits, actions)


def make_vtrace_loss(bundle, *, value_coef=0.5, entropy_coef=0.01, rho_bar=1.0, c_bar=1.0,
                     mtp_weight=0.1):
    """LM-policy V-trace loss. Batch fields, all (B, S) unless noted: tokens,
    rewards, discounts, behavior_logprobs, mask[, frontend (B, F, D)]. Token
    at position t >= 1 is the *action* taken given the prefix < t. With a
    frontend the model's outputs hold F more positions, before the tokens':
    logits and values are read from position F on, as in the reference.

    An LM's router loss (``out.aux_loss``, a 0-d tensor: zero for a dense
    LM) adds ``router_aux_coef`` times itself and the metric "router_aux";
    the families whose aux_loss is the plain 0.0 add neither, as in the
    reference. With MTP logits, position t's prediction of token t+2 adds
    ``mtp_weight`` times its masked cross-entropy, the metric "mtp_ce"."""
    cfg = bundle.cfg

    def loss_fn(params, batch):
        out = bundle.forward(params, batch)
        tokens = torch.as_tensor(batch["tokens"], device=out.logits.device)
        f = out.logits.shape[1] - tokens.shape[1]   # the modality frontend's positions
        logits, value = out.logits[:, f:], out.value[:, f:]
        actions = tokens[:, 1:]
        logits_t = logits[:, :-1]
        values_t = value[:, :-1]
        bootstrap = value[:, -1]
        logprob, entropy = _token_logprobs_entropy(logits_t, actions)
        mask = batch["mask"][:, 1:].float()

        vtr = vtrace(logprob, batch["behavior_logprobs"][:, 1:], batch["rewards"][:, 1:],
                     batch["discounts"][:, 1:], values_t, bootstrap, rho_bar=rho_bar,
                     c_bar=c_bar)
        pg, vl, en = vtrace_losses(logprob, entropy, vtr, values_t, mask,
                                   value_coef=value_coef, entropy_coef=entropy_coef)
        loss = pg + vl + en
        metrics = {"pg_loss": pg, "value_loss": vl, "entropy_loss": en}
        if torch.is_tensor(out.aux_loss) and out.aux_loss.numel() == 1:
            loss = loss + cfg.router_aux_coef * out.aux_loss
            metrics["router_aux"] = out.aux_loss
        if out.mtp_logits is not None:
            # auxiliary MTP cross-entropy: position t predicts token t+2
            lp, _ = _token_logprobs_entropy(out.mtp_logits[:, :-2], tokens[:, 2:])
            m2 = batch["mask"][:, 2:].float()
            mtp_ce = -(lp * m2).sum() / torch.clamp(m2.sum(), min=1.0)
            loss = loss + mtp_weight * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        metrics["loss"] = loss
        return loss, {k: v.detach() for k, v in metrics.items()}

    return loss_fn


def make_r2d2_loss(bundle, acfg):
    """R2D2 loss over replayed sequences. Batch: obs (B, burn+T, ...),
    actions/rewards/dones (B, burn+T), core: initial LSTM state; optional
    is_weights (B,), prioritized replay's importance weights.

    The online net is unrolled over burn-in and training segment, with the
    gradient through both, as the reference does; the target net runs
    under ``no_grad``. With is_weights the loss is the reference's
    importance-weighted form, ``0.5 mean(w td^2)``, built as it builds it
    from the ``td_error`` that ``r2d2_loss`` returns without gradient: its
    gradient is zero, as ``jax.grad`` of the reference's gives (ROADMAP
    section 3)."""

    def loss_fn(params, target_params, batch):
        burn = acfg.burn_in
        out, _ = atari_forward(acfg, params, batch)
        q = out.logits[:, burn:]
        with torch.no_grad():
            tout, _ = atari_forward(acfg, target_params, batch)
        q_t = tout.logits[:, burn:]
        res = r2d2_loss(None, q, q_t, batch["actions"][:, burn:], batch["rewards"][:, burn:],
                        batch["dones"][:, burn:], n_step=acfg.n_step, gamma=acfg.gamma,
                        priority_exponent=acfg.priority_exponent)
        loss = res.loss
        if "is_weights" in batch:   # prioritized-replay importance correction
            w = batch["is_weights"][:, None]
            loss = 0.5 * torch.mean(w * torch.square(res.td_error))
        return loss, {"loss": loss.detach(), "priorities": res.priorities}

    return loss_fn


def param_grads(loss, named):
    """{name: d loss / d param} over `named` ({name: param}), zeros for a
    param the loss does not reach, or for every param when the loss
    reaches none (as jax.grad gives). A DTensor param's gradient comes back
    with its placements (the partial sums over the ranks reduced)."""
    if not loss.requires_grad:
        return {n: torch.zeros_like(p) for n, p in named.items()}
    gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    out = {}
    for (n, p), g in zip(named.items(), gs):
        if g is None:
            g = torch.zeros_like(p)
        elif hasattr(p, "placements") and tuple(g.placements) != tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        out[n] = g
    return out


def make_train_step(bundle, optimizer, *, algo="vtrace", acfg=None, **kw):
    """Returns train_step(state, batch) -> (state, metrics). V-trace: with
    ``cfg.grad_accum`` > 1 the batch is split into that many micro-batches
    along B, their grads summed in fp32 and divided by the count (the
    reference scans them), and the metrics averaged. R2D2 (``algo="r2d2"``,
    `acfg` an ``AtariConfig``): after the AdamW step the target takes the
    params when the new step is a multiple of ``target_update_period``."""
    if algo == "r2d2":
        if acfg is None:
            raise ValueError("algo='r2d2' needs acfg, the AtariConfig")
        return _r2d2_train_step(bundle, optimizer, acfg)
    if algo != "vtrace":
        raise ValueError(f"unknown algo {algo!r}; use 'vtrace' or 'r2d2'")
    loss_fn = make_vtrace_loss(bundle, **kw)
    accum = getattr(bundle.cfg, "grad_accum", 1)

    def train_step(state, batch):
        params = state["params"]
        named = dict(params.named_parameters())
        if accum <= 1:
            loss, metrics = loss_fn(params, batch)
            grads = param_grads(loss, named)
        else:
            mbs = batch["tokens"].shape[0] // accum
            gsum = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named.items()}
            ms = []
            for i in range(accum):
                micro = {k: v[i * mbs:(i + 1) * mbs] for k, v in batch.items()}
                loss, m = loss_fn(params, micro)
                with torch.no_grad():
                    for n, g in param_grads(loss, named).items():
                        gsum[n].add_(g.float())
                ms.append(m)
                del loss
            with torch.no_grad():
                grads = {n: g.div_(accum).to(named[n].dtype) for n, g in gsum.items()}
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        updates, opt_state, om = optimizer.update(grads, state["opt_state"], named,
                                                  state["step"])
        apply_updates(named, updates)
        metrics.update(om)
        return {"params": params, "opt_state": opt_state, "step": state["step"] + 1}, metrics

    return train_step


def _r2d2_train_step(bundle, optimizer, acfg):
    loss_fn = make_r2d2_loss(bundle, acfg)

    def train_step(state, batch):
        params, target = state["params"], state["target"]
        named = dict(params.named_parameters())
        loss, metrics = loss_fn(params, target, batch)
        grads = param_grads(loss, named)
        del loss
        updates, opt_state, om = optimizer.update(grads, state["opt_state"], named,
                                                  state["step"])
        apply_updates(named, updates)
        step = state["step"] + 1
        if step % acfg.target_update_period == 0:
            with torch.no_grad():
                for t, p in zip(target.parameters(), params.parameters()):
                    t.copy_(p)
        metrics.update(om)
        return {"params": params, "opt_state": opt_state, "step": step,
                "target": target}, metrics

    return train_step
