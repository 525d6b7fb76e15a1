"""Train-step builders for the LM policies: the V-trace actor-critic loss.

Mirrors ``repro.core.losses`` (its V-trace half; ``make_r2d2_loss`` waits
for the R2D2 slice). The train state is a dict {params, opt_state, step}:
params the family's ``nn.Module`` with its parameters trainable, opt_state
the optimizer's dicts keyed by parameter name, step a Python int.
``make_train_step`` returns a function that updates the state in place
under ``no_grad`` (the counterpart of the JAX step's ``donate_argnums=(0,)``)
and returns it with the step's metrics as 0-d device tensors; it never
waits on the device, so a caller that prints a metric pays the sync there.
"""

import torch

from repro_torch.core.vtrace import vtrace, vtrace_losses
from repro_torch.optim.adamw import apply_updates


def init_train_state(bundle, optimizer, seed=0, device="cuda", dtype=None):
    """Params built by ``bundle.init`` and made trainable (every parameter of
    the port is made with ``requires_grad=False``, as serving wants), the
    optimizer's state over them, and step 0."""
    params = bundle.init(seed, device=device, dtype=dtype)
    params.requires_grad_(True)
    return {"params": params, "opt_state": optimizer.init(dict(params.named_parameters())),
            "step": 0}


def _token_logprobs_entropy(logits, actions):
    """logits (B,T,V) fp32, actions (B,T). Returns (logprob, entropy) (B,T).

    The action's logit is read with ``gather``: on one card it gives the
    same value as the reference's one-hot contraction, which exists so
    that GSPMD keeps vocab-sharded logits sharded, without building a
    (B,T,V) mask."""
    lse = torch.logsumexp(logits, dim=-1)
    a_logit = torch.gather(logits, -1, actions[..., None].long())[..., 0]
    logprob = a_logit - lse
    # entropy = lse - E_p[logit]
    p = torch.softmax(logits, dim=-1)
    entropy = lse - torch.sum(p * logits, dim=-1)
    return logprob, entropy


def make_vtrace_loss(bundle, *, value_coef=0.5, entropy_coef=0.01, rho_bar=1.0, c_bar=1.0):
    """LM-policy V-trace loss. Batch fields, all (B, S): tokens, rewards,
    discounts, behavior_logprobs, mask. Token at position t >= 1 is the
    *action* taken given the prefix < t."""

    def loss_fn(params, batch):
        out = bundle.forward(params, batch)   # no modality frontend: one position a token
        actions = torch.as_tensor(batch["tokens"], device=out.logits.device)[:, 1:]
        logits_t = out.logits[:, :-1]
        values_t = out.value[:, :-1]
        bootstrap = out.value[:, -1]
        logprob, entropy = _token_logprobs_entropy(logits_t, actions)
        mask = batch["mask"][:, 1:].float()

        vtr = vtrace(logprob, batch["behavior_logprobs"][:, 1:], batch["rewards"][:, 1:],
                     batch["discounts"][:, 1:], values_t, bootstrap, rho_bar=rho_bar,
                     c_bar=c_bar)
        pg, vl, en = vtrace_losses(logprob, entropy, vtr, values_t, mask,
                                   value_coef=value_coef, entropy_coef=entropy_coef)
        loss = pg + vl + en
        metrics = {"pg_loss": pg, "value_loss": vl, "entropy_loss": en, "loss": loss}
        return loss, {k: v.detach() for k, v in metrics.items()}

    return loss_fn


def param_grads(loss, named):
    """{name: d loss / d param} over `named` ({name: param}), zeros for a
    param the loss does not reach (as jax.grad gives)."""
    gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named.items(), gs)}


def make_train_step(bundle, optimizer, **kw):
    """Returns train_step(state, batch) -> (state, metrics). With
    ``cfg.grad_accum`` > 1 the batch is split into that many micro-batches
    along B, their grads summed in fp32 and divided by the count (the
    reference scans them), and the metrics averaged."""
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
            gsum = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for n, p in named.items()}
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
