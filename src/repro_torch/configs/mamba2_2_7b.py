"""Mamba2-2.7B: SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, d_ff=0, vocab_size=50280,
    norm="rmsnorm", tie_embeddings=True,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_ngroups=1, ssm_conv=4,
    ssm_chunk=256,
    pure_dp=True,
)
