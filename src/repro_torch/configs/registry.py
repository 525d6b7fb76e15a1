"""--arch <id> resolution: maps arch ids to configs and model builders.

Mirrors ``repro.configs.registry``, every arch of which is ported.
"""

import importlib

_MODULES = {
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "r2d2-atari": "repro_torch.configs.r2d2_atari",
}

# the R2D2 agent is not an LM: --arch lists leave it out, as the reference's do
ARCHS = tuple(k for k in _MODULES if k != "r2d2-atari")


def list_archs():
    return ARCHS


def get_config(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port supports {tuple(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.CONFIG


def make_model(cfg):
    """Build the ModelBundle for a config (dispatch on family)."""
    if cfg.family == "atari":
        from repro_torch.models.atari import make_atari
        return make_atari(cfg)
    if cfg.family == "ssm":
        from repro_torch.models.mamba import make_mamba
        return make_mamba(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models.recurrentgemma import make_recurrentgemma
        return make_recurrentgemma(cfg)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import make_encdec
        return make_encdec(cfg)
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    from repro_torch.models.lm import make_lm
    return make_lm(cfg)


def smoke_config(arch: str):
    """A reduced config of the same family for CPU smoke tests."""
    cfg = get_config(arch)
    if cfg.family == "atari":
        return cfg
    small = dict(num_layers=4, d_model=64, d_ff=128, vocab_size=277,
                 max_position=256)
    if cfg.num_heads:
        small.update(num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 2),
                     head_dim=16)
    if cfg.family == "moe":
        small.update(num_experts=8, num_experts_per_tok=2, moe_d_ff=32,
                     first_dense_layers=min(cfg.first_dense_layers, 1),
                     capacity_factor=8.0)
    if cfg.mla:
        small.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                     qk_rope_head_dim=8, v_head_dim=16)
    if cfg.family == "ssm":
        small.update(ssm_state=16, ssm_headdim=8, ssm_chunk=16)
    if cfg.family == "hybrid":
        small.update(lru_width=64, local_window=32,
                     num_layers=len(cfg.block_pattern) + 2)
    if cfg.family == "encdec":
        small.update(enc_layers=2, dec_layers=2, num_layers=4)
    if cfg.attn_pattern != ("global",):
        small.update(num_layers=len(cfg.attn_pattern) * 2, local_window=32)
    if cfg.frontend_tokens:
        small.update(frontend_tokens=8, frontend_dim=24)
    if cfg.mtp_depth:
        small.update(mtp_depth=1)
    return cfg.with_(**small, remat="none", fsdp="none", tp=1,
                     grad_accum=1, optimizer_dtype="float32")
