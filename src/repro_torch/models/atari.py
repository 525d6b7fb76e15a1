"""The paper's exact workload: R2D2 conv-LSTM agent (Kapturowski et al. '19)
for ALE — Nature-DQN conv torso, LSTM core, dueling Q heads.

Mirrors ``repro.models.atari``. Parameters keep the JAX layout, so
``convert.params_from_jax`` passes them through by name: conv ``w`` HWIO
(k, k, c_in, c_out), ``torso_out.w`` (flat, core_dim), ``lstm.wi``/``wh``
(d, 4 d), ``adv``/``val`` (core_dim, A) and (core_dim, 1). Observations
arrive NHWC, as the envs emit them. ``F.conv2d`` takes NCHW input and OIHW
weights, so both are permuted where they are used (an NHWC tensor
permuted to NCHW is already in the channels-last layout that cuDNN reads
directly), and the torso's output is permuted back before it is flattened:
the flatten order is (H, W, C), as in the reference, so that
``torso_out.w`` reads its rows in the order they were trained in. uint8
frames are scaled by 1/255 on the device, so they cross to the card as
uint8 (a quarter of the bytes of fp32).
"""

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import dtype_of, resolve
from repro_torch.models.common import ModelBundle, ModelOutputs
from repro_torch.nn import init as inits
from repro_torch.nn.recurrent import LSTM, lstm_scan, lstm_state_init, lstm_step

CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))   # (features, kernel, stride)


def _conv_out_hw(hw, kernel, stride):
    return (hw - kernel) // stride + 1


def _torso_dims(cfg):
    h = w = cfg.obs_size
    cin = cfg.obs_channels
    for feats, k, s in CONVS:
        h, w = _conv_out_hw(h, k, s), _conv_out_hw(w, k, s)
        cin = feats
    return h * w * cin


class Dense(nn.Module):
    """A weight w of `shape`, its last axis the outputs (a product's
    (d_in, d_out), a convolution's HWIO), drawn by fan-in over `fan_axes`
    (all but the last by default), and a bias b (d_out,)."""

    def __init__(self, shape, *, fan_axes=None, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.w = nn.Parameter(inits.fan_in(in_axes=fan_axes)(gen, shape, dtype, device),
                              requires_grad=False)
        self.b = nn.Parameter(inits.zeros(gen, (shape[-1],), dtype, device),
                              requires_grad=False)


class Atari(nn.Module):
    """Parameters of the conv-LSTM agent, built directly in `dtype` (fp32,
    as the reference builds them) on `device` from a seeded
    torch.Generator on that device."""

    def __init__(self, cfg, seed=0, device="cuda", dtype=None):
        super().__init__()
        dev = resolve(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        kw = dict(gen=gen, dtype=dtype_of(dtype or torch.float32), device=dev)
        cin = cfg.obs_channels
        for i, (feats, k, _) in enumerate(CONVS):
            self.add_module(f"conv{i}", Dense((k, k, cin, feats), fan_axes=(0, 1, 2), **kw))
            cin = feats
        self.torso_out = Dense((_torso_dims(cfg), cfg.core_dim), **kw)
        self.lstm = LSTM(cfg.core_dim, cfg.core_dim, **kw)
        self.adv = Dense((cfg.core_dim, cfg.num_actions), **kw)
        self.val = Dense((cfg.core_dim, 1), **kw)

    @property
    def device(self):
        return self.torso_out.w.device


def _torso(cfg, p, obs):
    """obs (N, H, W, C) uint8/float -> (N, core_dim)."""
    obs = torch.as_tensor(obs, device=p.device)
    x = obs.float() / 255.0 if obs.dtype == torch.uint8 else obs.float()
    x = x.permute(0, 3, 1, 2)                                   # NHWC -> NCHW
    for i, (_, _, s) in enumerate(CONVS):
        c = getattr(p, f"conv{i}")
        x = F.relu(F.conv2d(x, c.w.permute(3, 2, 0, 1), c.b, stride=s))   # HWIO -> OIHW
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)          # flatten in (H, W, C)
    return F.relu(x @ p.torso_out.w + p.torso_out.b)


def _duel(p, h):
    adv = h @ p.adv.w + p.adv.b
    val = h @ p.val.w + p.val.b
    return val + adv - adv.mean(dim=-1, keepdim=True)


def atari_forward(cfg, params, batch):
    """batch['obs'] (B,T,H,W,C); optional batch['core'] initial LSTM state.
    Returns (ModelOutputs with the q-values (B,T,A) as .logits, the final
    LSTM state)."""
    obs = torch.as_tensor(batch["obs"], device=params.device)
    b, t = obs.shape[:2]
    e = _torso(cfg, params, obs.reshape((b * t,) + obs.shape[2:]))
    e = e.reshape(b, t, -1)
    state = batch.get("core")
    if state is None:
        state = lstm_state_init(b, cfg.core_dim, device=params.device)
    hs, state = lstm_scan(params.lstm, e, state)
    q = _duel(params, hs)
    return ModelOutputs(logits=q, value=q.max(dim=-1).values), state


def atari_step(cfg, params, obs_t, state):
    """Single env step for actor inference: obs (B,H,W,C) -> (q (B,A), state)."""
    e = _torso(cfg, params, obs_t)
    h, state = lstm_step(params.lstm, e, state)
    return _duel(params, h), state


def make_atari(cfg) -> ModelBundle:
    return ModelBundle(
        cfg=cfg,
        init=lambda seed=0, device="cuda", dtype=None: Atari(cfg, seed, device, dtype),
        forward=lambda params, batch: atari_forward(cfg, params, batch)[0],
        init_cache=lambda batch, max_len=None, dtype=torch.float32, device="cuda":
            lstm_state_init(batch, cfg.core_dim, dtype, device),
        prefill=None,
        decode_step=lambda params, obs_t, state: atari_step(cfg, params, obs_t, state),
    )
