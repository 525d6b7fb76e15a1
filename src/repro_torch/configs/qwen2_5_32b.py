"""Qwen2.5-32B: dense GQA with QKV bias. [hf:Qwen/Qwen2.5 family; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=27648, vocab_size=152064, act="silu", norm="rmsnorm",
    qkv_bias=True, rope_theta=1e6, remat="full", fsdp="data",
    grad_accum=8,
)
