"""Unified model/run configuration.

A copy of ``repro.configs.base`` (pure Python), kept so that the port
imports nothing of the JAX package. The dtype fields name torch dtypes by
the same strings ("float32", "bfloat16").

One dataclass covers every assigned architecture family (dense / MoE / MLA /
local-global / hybrid RG-LRU / SSM / enc-dec / modality-stub). Field groups
are inert unless the family uses them; ``validate()`` enforces coherence.
"""

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def pad_to(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n."""
    return ((n + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|encdec
    modality: str = "text"            # text|vision|audio (frontend stub kind)

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                 # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0
    act: str = "silu"                 # silu|gelu|gelu_tanh
    norm: str = "rmsnorm"             # rmsnorm|layernorm
    norm_eps: float = 1e-6
    post_block_norm: bool = False     # gemma2: extra norm after attn/mlp
    gemma_scale: bool = False         # norm scale parameterized as (1+s)
    embed_scale: bool = False         # multiply embeddings by sqrt(d_model)
    tie_embeddings: bool = False
    qkv_bias: bool = False
    mlp_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    max_position: int = 524_288

    # --- attention pattern ---
    attn_pattern: Tuple[str, ...] = ("global",)   # cycled over layers
    local_window: int = 4096
    attn_softcap: Optional[float] = None          # gemma2
    final_softcap: Optional[float] = None         # gemma2
    attn_scale: Optional[float] = None            # override 1/sqrt(head_dim)

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0                   # deepseek: first k layers dense
    router_aux_coef: float = 0.001
    router_score: str = "softmax"                 # softmax|sigmoid (dsv3)
    capacity_factor: float = 1.25

    # --- MLA (DeepSeek) ---
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0                            # multi-token-prediction heads

    # --- SSM (Mamba2 SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (RecurrentGemma) ---
    block_pattern: Tuple[str, ...] = ()           # e.g. ("rglru","rglru","local")
    lru_width: int = 0

    # --- enc-dec (Seamless) ---
    enc_layers: int = 0
    dec_layers: int = 0

    # --- modality frontend stub ---
    frontend_tokens: int = 0                      # patches/frames per example
    frontend_dim: int = 0

    # --- distribution ---
    tp: int = 1                                   # model-axis degree (padding basis)
    fsdp: str = "none"                            # none|data|pod_data
    # Megatron-SP residual stream. Default OFF: on this XLA version GSPMD
    # lowers the seq-shard <-> tensor-shard transitions as AG + AR (+41%
    # collective bytes) instead of AG/RS — see EXPERIMENTS.md §Perf iter 2/3.
    seq_parallel: bool = False
    grad_accum: int = 1                           # micro-batches per step
    kv_seq_shard: bool = True                     # shard KV-cache seq over model
    moe_impl: str = "ep"                          # ep (shard_map)|gather
    # pure data parallelism: replicate params and use the 'model' axis as
    # extra batch parallelism. The right production sharding for models
    # whose weights fit one chip — TP=16 on a ~1-3B model is pure
    # collective overhead (see EXPERIMENTS.md §Perf iter 7).
    pure_dp: bool = False
    remat: str = "none"                           # none|full|dots
    scan_layers: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    optimizer_dtype: str = "float32"              # adam moment dtype

    # --- RL head / algorithm ---
    algo: str = "vtrace"                          # vtrace|r2d2
    num_actions: int = 0                          # 0 -> vocab_size (token actions)

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived, padding-aware quantities ----
    @property
    def padded_heads(self) -> int:
        # padded to a multiple of lcm(tp, kv_heads) so the padded head count
        # both shards evenly over 'model' and groups evenly over KV heads.
        import math
        base = math.lcm(max(self.tp, 1), max(self.num_kv_heads, 1))
        return pad_to(self.num_heads, base)

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, 256 if self.tp > 1 else 1)

    @property
    def actions(self) -> int:
        return self.num_actions or self.vocab_size

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def ssm_dinner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_dinner // self.ssm_headdim

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        assert self.family in ("dense", "moe", "ssm", "hybrid", "encdec")
        if self.family in ("dense", "moe", "encdec"):
            assert self.num_heads and self.d_model and self.vocab_size
            assert self.num_heads % max(self.num_kv_heads, 1) == 0
        if self.family == "moe":
            assert self.num_experts and self.num_experts_per_tok
            if self.tp > 1:
                assert self.num_experts % self.tp == 0, "EP needs experts % tp == 0"
        if self.family == "ssm":
            assert self.ssm_state and self.ssm_dinner % self.ssm_headdim == 0
        if self.family == "hybrid":
            assert self.block_pattern and self.lru_width
        if self.family == "encdec":
            assert self.enc_layers and self.dec_layers
        if self.tp > 1:
            assert self.d_model % self.tp == 0, f"{self.name}: d_model % tp"


def param_count(cfg: ModelConfig) -> float:
    """Analytic parameter count N (for MODEL_FLOPS = 6*N*D)."""
    d, v = cfg.d_model, cfg.vocab_size
    n = v * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "ssm":
        din, ns, nh = cfg.ssm_dinner, cfg.ssm_state, cfg.ssm_nheads
        per = d * (2 * din + 2 * cfg.ssm_ngroups * ns + nh) \
            + cfg.ssm_conv * (din + 2 * cfg.ssm_ngroups * ns) + din * d + 2 * nh + d
        return n + cfg.num_layers * per
    if cfg.family == "hybrid":
        per_attn = d * cfg.num_heads * cfg.head_dim + 2 * d * cfg.num_kv_heads * cfg.head_dim \
            + cfg.num_heads * cfg.head_dim * d
        w = cfg.lru_width
        per_rec = 2 * d * w + w * d + 2 * (w // 8) * w // (w // 8) * 1 + 4 * w  # proj + conv-ish + gates
        per_mlp = 3 * d * cfg.d_ff
        n_rec = sum(1 for i in range(cfg.num_layers)
                    if cfg.block_pattern[i % len(cfg.block_pattern)] == "rglru")
        n_att = cfg.num_layers - n_rec
        return n + n_rec * (per_rec + per_mlp) + n_att * (per_attn + per_mlp)
    # attention families
    hd = cfg.head_dim
    per_attn = d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd + cfg.num_heads * hd * d
    if cfg.mla:
        per_attn = (d * cfg.q_lora_rank
                    + cfg.q_lora_rank * cfg.num_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
                    + d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
                    + cfg.kv_lora_rank * cfg.num_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)
                    + cfg.num_heads * cfg.v_head_dim * d)
    per_mlp_dense = 3 * d * cfg.d_ff
    if cfg.family == "moe":
        per_moe = 3 * d * cfg.moe_d_ff * (cfg.num_experts + cfg.n_shared_experts) \
            + d * cfg.num_experts
        k = cfg.first_dense_layers
        return n + k * (per_attn + per_mlp_dense) + (cfg.num_layers - k) * (per_attn + per_moe)
    layers = cfg.enc_layers + cfg.dec_layers if cfg.family == "encdec" else cfg.num_layers
    cross = cfg.dec_layers * per_attn if cfg.family == "encdec" else 0
    return n + layers * (per_attn + per_mlp_dense) + cross


def active_param_count(cfg: ModelConfig) -> float:
    """Active params per token (MoE: only routed-in experts)."""
    if cfg.family != "moe":
        return param_count(cfg)
    d = cfg.d_model
    per_attn = (d * cfg.q_lora_rank
                + cfg.q_lora_rank * cfg.num_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
                + d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
                + cfg.kv_lora_rank * cfg.num_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)
                + cfg.num_heads * cfg.v_head_dim * d) if cfg.mla else \
        (d * cfg.num_heads * cfg.head_dim + 2 * d * cfg.num_kv_heads * cfg.head_dim
         + cfg.num_heads * cfg.head_dim * d)
    per_moe_active = 3 * d * cfg.moe_d_ff * (cfg.num_experts_per_tok + cfg.n_shared_experts) \
        + d * cfg.num_experts
    k = cfg.first_dense_layers
    n = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return n + k * (per_attn + 3 * d * cfg.d_ff) + (cfg.num_layers - k) * (per_attn + per_moe_active)
