"""chatglm3-6b [dense] — 2-D RoPE (rotary on half the head dims), GQA kv=2,
QKV bias [arXiv:2406.12793].

28L d_model=4096 32H (kv=2, head_dim=128) d_ff=13696 vocab=65024.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=65024,
    act="swiglu",
    qkv_bias=True,
    rope="rope2d",
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=256,
    vocab=128, dtype="float32", remat=False,
)
