"""starcoder2-7b [dense] — GQA, RoPE, GELU MLP with biases [arXiv:2402.19173].

32L d_model=4608 36H (GQA kv=4, head_dim=128) d_ff=18432 vocab=49152.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab=49152,
    act="gelu",
    qkv_bias=True,
    mlp_bias=True,
    rope="rope",
    norm="layernorm",
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=256,
    vocab=128, dtype="float32", remat=False,
)
