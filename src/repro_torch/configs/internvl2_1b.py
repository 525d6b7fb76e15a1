"""InternVL2-1B [vlm]: InternViT frontend (stub) + Qwen2-0.5B-class LM
backbone. [arXiv:2404.16821; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="dense", modality="vision",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151655, act="silu", norm="rmsnorm",
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    frontend_tokens=256, frontend_dim=1024,
    pure_dp=True,
)
