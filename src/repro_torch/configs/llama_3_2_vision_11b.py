"""llama-3.2-vision-11b [vlm] — text backbone with gated cross-attention
image layers every 5th layer [hf:meta-llama/Llama-3.2-11B-Vision].

40L d_model=4096 32H (GQA kv=8, head_dim=128) d_ff=14336 vocab=128256.
The vision encoder is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (B, n_image_tokens, d_model).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128256,
    act="swiglu",
    rope="rope",
    rope_theta=500000.0,
    cross_attn_every=5,
    n_image_tokens=1601,
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=256,
    vocab=128, cross_attn_every=2, n_image_tokens=16, dtype="float32", remat=False,
)
