"""TokenWorld: a token-level environment for LM policies, and synthetic
V-trace trajectories for the LM learner.

Mirrors ``repro.envs.tokenworld``. The agent emits tokens; reward +1 when
the emitted token continues a hidden periodic pattern, 0 otherwise. Dense
rewards and a tiny state make it a fast testbed for the V-trace LM-policy
path. `TokenWorld` is batched over E lanes on a torch device, like
`envs.catch.CatchEnv`: per lane a position and a ``(period,)`` pattern,
drawn from an explicit ``torch.Generator`` (a fresh pattern for every lane
each step, kept where a lane ends, as the reference draws one each step).

`synthetic_vtrace_batch` has the reference's field layout, drawn from a
generator on the target device (the numbers differ from ``jax.random``'s;
parity tests feed both packages one batch), with the modality frontend's
(B, F, D) bf16 field when asked for one.
"""

from typing import NamedTuple

import torch

from repro_torch.device import resolve


class TokenWorldState(NamedTuple):
    pos: torch.Tensor      # (E,) int64
    pattern: torch.Tensor  # (E, period) int64


class TokenWorld:
    obs_shape = ()

    def __init__(self, vocab_size=64, period=4, episode_len=32, device="cuda"):
        self.vocab_size = vocab_size
        self.period = period
        self.episode_len = episode_len
        self.num_actions = vocab_size
        self.device = resolve(device)

    def _patterns(self, n, gen):
        return torch.randint(0, self.vocab_size, (n, self.period), generator=gen,
                             device=self.device)

    def obs(self, st: TokenWorldState) -> torch.Tensor:
        """(E,) int64: each lane's next target token, pattern[pos % period]."""
        return torch.gather(st.pattern, 1, (st.pos % self.period)[:, None])[:, 0]

    def reset(self, num_envs: int, gen: torch.Generator):
        st = TokenWorldState(pos=torch.zeros((num_envs,), dtype=torch.int64, device=self.device),
                             pattern=self._patterns(num_envs, gen))
        return st, self.obs(st)

    def step(self, st: TokenWorldState, action: torch.Tensor, gen: torch.Generator):
        """(state, obs, reward, done) over the lanes; a lane ends after
        `episode_len` tokens and restarts at position 0 on a new pattern."""
        reward = (action == self.obs(st)).to(torch.float32)
        pos = st.pos + 1
        done = pos >= self.episode_len
        new = TokenWorldState(pos=torch.where(done, 0, pos),
                              pattern=torch.where(done[:, None],
                                                  self._patterns(done.shape[0], gen), st.pattern))
        return new, self.obs(new), reward, done


def synthetic_vtrace_batch(gen, batch, seq, vocab, frontend=None):
    """A trajectory batch with the exact field layout the learner consumes,
    on `gen`'s device: tokens (B,S) int64, rewards, discounts,
    behavior_logprobs and mask (B,S) fp32; with `frontend` = (f_tokens,
    f_dim), a (B, f_tokens, f_dim) bf16 field of standard normals from the
    same generator, as the reference's."""
    dev = gen.device
    out = {
        "tokens": torch.randint(0, vocab, (batch, seq), generator=gen, device=dev),
        "rewards": torch.randn((batch, seq), generator=gen, device=dev) * 0.1,
        "discounts": torch.full((batch, seq), 0.99, device=dev),
        "behavior_logprobs": -torch.randn((batch, seq), generator=gen, device=dev).abs(),
        "mask": torch.ones((batch, seq), device=dev),
    }
    if frontend is not None:
        f_tokens, f_dim = frontend
        out["frontend"] = torch.randn((batch, f_tokens, f_dim), generator=gen,
                                      device=dev).to(torch.bfloat16)
    return out
