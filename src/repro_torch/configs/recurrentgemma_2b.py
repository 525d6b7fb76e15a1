"""RecurrentGemma-2B: RG-LRU + local attention, 1:2 pattern.
[arXiv:2402.19427; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000, act="gelu_tanh", norm="rmsnorm",
    gemma_scale=True, embed_scale=True, tie_embeddings=True,
    block_pattern=("rglru", "rglru", "local"), local_window=2048,
    lru_width=2560, rope_theta=10000.0,
    pure_dp=True,
)
