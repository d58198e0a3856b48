"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP [arXiv:2402.16819].

96L d_model=18432 96H (GQA kv=8, head_dim=192) d_ff=73728 vocab=256000.
Pure full attention -> long_500k is skipped (DESIGN.md §6).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab=256000,
    act="relu2",
    rope="rope",
    norm="layernorm",
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=256,
    vocab=128, dtype="float32", remat=False,
)
