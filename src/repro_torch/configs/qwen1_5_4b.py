"""qwen1.5-4b [dense] — MHA (kv=heads), QKV bias [hf:Qwen/Qwen1.5].

40L d_model=2560 20H (kv=20, head_dim=128) d_ff=6912 vocab=151936.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab=151936,
    act="swiglu",
    qkv_bias=True,
    rope="rope",
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=256,
    vocab=128, dtype="float32", remat=False,
)
