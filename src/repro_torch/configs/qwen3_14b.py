"""Qwen3-14B: dense, qk-norm, GQA. [hf:Qwen/Qwen3-8B family; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=17408, vocab_size=151936, act="silu", norm="rmsnorm", qk_norm=True,
    rope_theta=1e6, remat="full", grad_accum=4,
)
