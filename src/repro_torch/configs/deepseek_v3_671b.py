"""DeepSeek-V3 671B: MLA, 1 shared + 256 routed experts top-8, MTP.
[arXiv:2412.19437; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=18432, vocab_size=129280, act="silu", norm="rmsnorm",
    rope_theta=10000.0,
    num_experts=256, num_experts_per_tok=8, moe_d_ff=2048,
    n_shared_experts=1, first_dense_layers=3, router_score="sigmoid",
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    mtp_depth=1,
    fsdp="pod_data", optimizer_dtype="bfloat16", remat="full",
    grad_accum=8,
)
