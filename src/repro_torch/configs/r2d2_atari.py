"""The paper's own workload: R2D2 conv-LSTM agent on ALE (SEED RL impl).

A copy of ``repro.configs.r2d2_atari``. The defaults are the published
R2D2 widths and hyper-parameters (Kapturowski et al. 2019): 84x84x4
frames, an LSTM core of 512, the full action set of 18, burn-in 40,
unroll 80, n-step 5, gamma 0.997.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class AtariConfig:
    name: str = "r2d2-atari"
    family: str = "atari"
    obs_size: int = 84
    obs_channels: int = 4
    core_dim: int = 512
    num_actions: int = 18
    algo: str = "r2d2"
    # R2D2 hyper-parameters (Kapturowski et al.)
    burn_in: int = 40
    unroll: int = 80
    n_step: int = 5
    gamma: float = 0.997
    target_update_period: int = 2500
    priority_exponent: float = 0.9
    importance_exponent: float = 0.6


CONFIG = AtariConfig()
