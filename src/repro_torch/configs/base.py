"""Model and run configuration dataclasses (a copy of the JAX package's
``configs/base.py`` without its shape table)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str = "dense"          # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 0            # 0 -> = n_heads (MHA)
    head_dim: int = 0              # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab: int = 32000
    act: str = "swiglu"            # swiglu | geglu | gelu | relu2
    qkv_bias: bool = False
    mlp_bias: bool = False
    rope: str = "rope"             # rope | rope2d | none
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0     # chatglm rope-2d applies rotary to half dims
    causal: bool = True
    encoder_only: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_dff: int = 0
    n_shared_experts: int = 0
    moe_every: int = 1             # MoE replaces dense MLP every Nth layer
    capacity_factor: float = 1.25
    moe_groups: int = 0          # dispatch groups (0 = one per data shard)
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 64
    # --- hybrid (Zamba-2) ---
    shared_attn_every: int = 0     # apply the shared attention block every Nth layer
    # --- VLM ---
    cross_attn_every: int = 0      # a cross-attn layer every Nth layer
    n_image_tokens: int = 0
    # --- audio/vision frontend stubs ---
    frontend: str = "none"         # none | frames (precomputed embeddings input)
    # --- numerics / implementation ---
    param_dtype: str = "float32"
    dtype: str = "bfloat16"        # activation compute dtype for large runs
    attn_impl: str = "xla"         # xla | xla_chunked | pallas
    seq_shard_attn: str = "auto"   # auto | on | off — sequence-parallel q
                                   # fallback when heads don't divide the TP axis
    seq_parallel_norms: bool = False  # Megatron-style sequence parallelism for
                                      # the residual stream (norms/adds sharded
                                      # over the model axis between blocks)
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots | full
    scan_layers: bool = True
    logit_chunk: int = 0           # 0 = unchunked cross-entropy
    max_seq: int = 8192            # learned-pos-embedding table size (audio stub)

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k (per assignment: SSM/hybrid only)?"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return not self.encoder_only

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """End-to-end run settings consumed by the Trainer / launcher."""

    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = "/tmp/repro_ckpt"
    keep_ckpts: int = 3
    seed: int = 0
    grad_clip: float = 1.0
    lowrank_grad_accum: bool = False   # beyond-paper: accumulate PᵀG
    resume: bool = True
