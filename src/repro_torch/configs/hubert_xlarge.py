"""hubert-xlarge [audio] — encoder-only transformer backbone
[arXiv:2106.07447].

48L d_model=1280 16H MHA (head_dim=80) d_ff=5120 vocab=504 (unit targets).
The wav2vec2 conv frontend is a STUB per the assignment: input_specs()
provides precomputed frame embeddings (B, S, d_model).  No decode step
(encoder-only) -> decode shapes are skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    act="gelu",
    rope="none",
    norm="layernorm",
    causal=False,
    encoder_only=True,
    frontend="frames",
    max_seq=32768,
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=256,
    vocab=64, max_seq=64, dtype="float32", remat=False,
)
