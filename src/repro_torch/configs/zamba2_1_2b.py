"""zamba2-1.2b [hybrid] — Mamba-2 backbone + shared attention block applied
every 6th layer (one set of attn+MLP weights reused) [arXiv:2411.15242].

38L d_model=2048, ssm_state=64; shared block: 32H MHA (head_dim=64) d_ff=8192,
vocab=32000.  Sub-quadratic -> long_500k RUNS for this arch.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    act="swiglu",
    rope="rope",
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=64,
    shared_attn_every=6,
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab=128, ssm_state=16, ssm_headdim=16, ssm_chunk=16, shared_attn_every=2,
    dtype="float32", remat=False,
)
