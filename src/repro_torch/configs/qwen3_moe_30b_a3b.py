"""Qwen3-MoE 30B-A3B: 128 experts, top-8, qk-norm GQA.
[hf:Qwen/Qwen3-30B-A3B; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=6144, vocab_size=151936, act="silu", norm="rmsnorm", qk_norm=True,
    rope_theta=1e6,
    num_experts=128, num_experts_per_tok=8, moe_d_ff=768,
    remat="full", grad_accum=4,
)
