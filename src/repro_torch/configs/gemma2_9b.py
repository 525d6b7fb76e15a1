"""Gemma2-9B: local+global alternating, logit softcaps, sandwich norms.
[arXiv:2408.00118; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000, act="gelu_tanh", norm="rmsnorm",
    gemma_scale=True, embed_scale=True, post_block_norm=True,
    tie_embeddings=True,
    attn_pattern=("local", "global"), local_window=4096,
    attn_softcap=50.0, final_softcap=30.0, attn_scale=0.0625,  # 1/sqrt(256)
    rope_theta=10000.0, remat="full", grad_accum=4,
)
