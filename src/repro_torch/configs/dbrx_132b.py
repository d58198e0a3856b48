"""dbrx-132b [moe] — 16 experts top-4 fine-grained MoE every layer
[hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8, head_dim=128) expert d_ff=10752 vocab=100352.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab=100352,
    act="swiglu",
    rope="rope",
    n_experts=16,
    top_k=4,
    moe_dff=10752,
    moe_every=1,
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab=128, n_experts=4, top_k=2, moe_dff=128, dtype="float32", remat=False,
)
