"""llama4-maverick-400b-a17b [moe] — 128-expert top-1 MoE with a shared
expert, MoE every other layer [hf:meta-llama/Llama-4].

48L d_model=5120 40H (GQA kv=8, head_dim=128), routed expert d_ff=8192,
vocab=202048.  moe_every=2 + shared expert reproduces the published totals:
24 MoE layers x 128 x 3 x 5120 x 8192 = 386B routed + dense/attn = ~400B
total, ~17B active (DESIGN.md §6).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,          # dense layers' MLP width
    vocab=202048,
    act="swiglu",
    rope="rope",
    n_experts=128,
    top_k=1,
    moe_dff=8192,
    n_shared_experts=1,
    moe_every=2,
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=256,
    vocab=128, n_experts=4, moe_dff=64, dtype="float32", remat=False,
)
