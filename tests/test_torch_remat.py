"""remat="dots", the port's selective checkpoint, against the JAX package's
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``, on the CPU.

Two cases a family (qwen3-14b, qwen3-moe-30b-a3b, recurrentgemma-2b,
mamba2-2.7b, seamless-m4t-large-v2 with its encoder and decoder layers):

- the saved set: the products that the port's policy saves in one forward
  (``models.common.dots_with_no_batch_dims_saveable`` returning
  ``MUST_SAVE``, keyed by (width, rows, dtype)) contain the reference's
  residuals under "dots" less those under "full" (read with
  ``saved_residuals``; a scanned stack's residual (L, B, S, ..., H, D) is
  L products of B * S rows and width H * D). The port saves more: every
  product with no batch dimension, where JAX keeps only those the backward
  reads. ``EXTRAS`` lists, per family, what the port saves beyond JAX, so
  that any drift of either side fails;
- one train step: ``make_train_step`` (AdamW at lr 1e-3) under "dots"
  against the reference's jitted ``make_train_step`` under "dots", at the
  tolerances of ``test_torch_train.test_one_train_step_matches_jax``.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax._src.ad_checkpoint import saved_residuals  # noqa: E402

from repro.configs.registry import make_model as jmake_model  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke_config  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.envs.tokenworld import synthetic_vtrace_batch as jbatch  # noqa: E402
from repro.optim.adamw import adamw as jadamw  # noqa: E402
from repro_torch.configs.registry import make_model, smoke_config  # noqa: E402
from repro_torch.core import losses  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from test_torch_train import S as STEP_S  # noqa: E402
from test_torch_train import (LR, _check_step, _close, _frontend, _params,  # noqa: E402
                              _port_state, _to_torch)

B, S = 2, 24        # the saved-set case's batch
FAMILIES = ("qwen3-14b", "qwen3-moe-30b-a3b", "recurrentgemma-2b", "mamba2-2.7b",
            "seamless-m4t-large-v2")
# (width, rows, dtype): count. What the port saves beyond the reference, at
# the smoke configs (d_model 64, d_ff 128, 4 heads of 16, 2 kv heads; B 2,
# S 24; seamless's 8 frames). JAX saves a product only where the backward of
# the rematted unit reads it, and a unit's last product (an MLP's down
# projection, Mamba2's out projection) feeds only the residual add that ends
# the unit: the next unit's input is saved as such. RecurrentGemma's unit is
# a whole period of 3 layers, and its layers after the last whole period run
# outside remat in the reference (``repro.models.recurrentgemma._run``), so
# they save every activation under both policies and "dots" less "full"
# holds none of theirs; the port remats every layer alone.
EXTRAS = {
    # the down projection of each of 4 layers
    "qwen3-14b": {(64, 48, "float32"): 4},
    # the MoE layer's last op is the experts' combine, a batched product
    "qwen3-moe-30b-a3b": {},
    # 5 layers (a period of rglru, rglru, local, then rglru, rglru outside
    # the reference's remat): the period's last down projection; the two
    # rest layers' six products of width 64 each (the x and y branches, the
    # RG-LRU's two gates, the out projection, the MLP's down) and their
    # MLP's gate and up
    "recurrentgemma-2b": {(64, 48, "float32"): 13, (128, 48, "float32"): 4},
    # the out projection of each of 4 layers
    "mamba2-2.7b": {(64, 48, "float32"): 4},
    # the down projection of each of 2 encoder layers (over 8 frames) and 2
    # decoder layers
    "seamless-m4t-large-v2": {(64, 16, "float32"): 2, (64, 48, "float32"): 2},
}


def _batch_free_product(op, args):
    """(width, rows, dtype) of a product that the policy saves."""
    a, b = (args[1], args[2]) if op is torch.ops.aten.addmm.default else args[:2]
    width = b.shape[-1] if b.dim() > 1 else 1
    return width, int(np.prod(a.shape[:-1])), str(a.dtype).removeprefix("torch.")


def _port_saved(arch, monkeypatch):
    """The products the port's "dots" policy saves in one forward of the
    smoke config, outside the recompute."""
    saved = collections.Counter()
    policy = common.dots_with_no_batch_dims_saveable

    def recording(ctx, op, *args, **kw):
        decision = policy(ctx, op, *args, **kw)
        if decision == common.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            saved[_batch_free_product(op, args)] += 1
        return decision
    monkeypatch.setattr(common, "dots_with_no_batch_dims_saveable", recording)
    cfg = smoke_config(arch).with_(remat="dots")
    bundle = make_model(cfg)
    params = bundle.init(0, device="cpu").requires_grad_(True)
    batch = {"tokens": torch.zeros((B, S), dtype=torch.long)}
    field = _frontend(cfg, B)
    if field is not None:
        batch["frontend"] = torch.from_numpy(field)
    bundle.forward(params, batch)
    return saved


def _jax_saved(arch):
    """The reference's residuals under "dots" less those under "full", as
    products: a scanned stack's (L, rows..., width...) is L products, its
    rows the leading dims whose product is a token count (B * S, or B times
    the frames)."""
    cfg = jsmoke_config(arch)
    tokens = {B * S} | ({B * cfg.frontend_tokens} if cfg.frontend_tokens else set())
    batch = {"tokens": jnp.zeros((B, S), jnp.int32)}
    field = _frontend(cfg, B)
    if field is not None:
        batch["frontend"] = jnp.asarray(field)

    def residuals(remat):
        jb = jmake_model(cfg.with_(remat=remat))
        params = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
        params = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), params)
        return collections.Counter((tuple(a.shape), str(a.dtype)) for a, _ in saved_residuals(
            lambda p: jb.forward(p, batch).logits.sum(), params))

    saved = collections.Counter()
    for (shape, dtype), n in (residuals("dots") - residuals("full")).items():
        stack, rest = shape[0], shape[1:]
        k = next(k for k in range(1, len(rest)) if int(np.prod(rest[:k])) in tokens)
        saved[(int(np.prod(rest[k:])), int(np.prod(rest[:k])), dtype)] += stack * n
    return saved


@pytest.mark.parametrize("arch", FAMILIES)
def test_saved_set_contains_jax(arch, monkeypatch):
    """The port saves every product that JAX saves under "dots", and beyond
    them exactly EXTRAS[arch]."""
    port, ref = _port_saved(arch, monkeypatch), _jax_saved(arch)
    assert ref, "the reference saved no product under 'dots'"
    assert not ref - port, f"saved by JAX, not by the port: {dict(ref - port)}"
    assert dict(port - ref) == EXTRAS[arch]


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_train_step_matches_jax(arch):
    """make_train_step under "dots" against the reference's jitted step under
    "dots": the loss, grad_norm, params and moments after one AdamW step as
    ``test_torch_train._check_step`` holds them, the loss's parts at 1e-4."""
    jcfg, cfg = (f(arch).with_(remat="dots") for f in (jsmoke_config, smoke_config))
    jbundle, bundle = jmake_model(jcfg), make_model(cfg)
    jparams, sd = _params(jbundle, bundle)
    batch = jax.tree.map(np.asarray, jbatch(jax.random.PRNGKey(1), B, STEP_S, cfg.vocab_size))
    field = _frontend(cfg, B)
    if field is not None:
        batch["frontend"] = field
    jopt, opt = jadamw(LR), adamw(LR)
    jstate, jm = jax.jit(jlosses.make_train_step(jbundle, jopt))(
        {"params": jparams, "opt_state": jopt.init(jparams), "step": jnp.zeros((), jnp.int32)},
        jax.tree.map(jnp.asarray, batch))
    state = _port_state(bundle, sd, opt)
    state, metrics = losses.make_train_step(bundle, opt)(state, _to_torch(batch))
    _check_step(bundle, jstate, jm, state, metrics)
    for k in ("pg_loss", "value_loss", "entropy_loss"):
        _close(metrics[k], jm[k], 1e-4)
