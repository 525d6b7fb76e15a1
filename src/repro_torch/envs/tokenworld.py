"""Synthetic V-trace trajectories for the LM policy.

Mirrors ``repro.envs.tokenworld.synthetic_vtrace_batch``: the same field
layout, drawn from an explicit ``torch.Generator`` on the target device
(the numbers differ from ``jax.random``'s; parity tests feed both packages
one batch). The ``TokenWorld`` env itself waits for the device backend, and
the modality frontend's field for the port's first model with a frontend.
"""

import torch


def synthetic_vtrace_batch(gen, batch, seq, vocab):
    """A trajectory batch with the exact field layout the learner consumes,
    on `gen`'s device: tokens (B,S) int64, rewards, discounts,
    behavior_logprobs and mask (B,S) fp32."""
    dev = gen.device
    out = {
        "tokens": torch.randint(0, vocab, (batch, seq), generator=gen, device=dev),
        "rewards": torch.randn((batch, seq), generator=gen, device=dev) * 0.1,
        "discounts": torch.full((batch, seq), 0.99, device=dev),
        "behavior_logprobs": -torch.randn((batch, seq), generator=gen, device=dev).abs(),
        "mask": torch.ones((batch, seq), device=dev),
    }
    return out
