"""SeamlessM4T-large v2 backbone [audio]: enc-dec, 24+24 layers; the speech
frontend is a stub providing precomputed frame embeddings.
[arXiv:2308.11596; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec", modality="audio",
    num_layers=48, enc_layers=24, dec_layers=24,
    d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256206, act="relu", norm="layernorm", norm_eps=1e-5,
    qkv_bias=True, mlp_bias=True,
    frontend_tokens=1024, frontend_dim=1024,
    pure_dp=True,
)
