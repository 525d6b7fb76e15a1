"""StarCoder2-15B: dense GQA, RoPE, layernorm+bias. [arXiv:2402.19173; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4, head_dim=128,
    d_ff=24576, vocab_size=49152, act="gelu_tanh", norm="layernorm",
    norm_eps=1e-5, qkv_bias=True, mlp_bias=True, rope_theta=1e5,
    remat="full", grad_accum=4,
)
