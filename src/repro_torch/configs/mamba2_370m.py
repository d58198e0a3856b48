"""mamba2-370m [ssm] — attention-free SSD (state-space duality)
[arXiv:2405.21060].

48L d_model=1024 (expand 2 -> d_inner 2048, 32 heads of 64), ssm_state=128,
vocab=50280.  Sub-quadratic -> long_500k RUNS for this arch.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=128,
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, vocab=128, ssm_state=16, ssm_headdim=16,
    ssm_chunk=16, dtype="float32", remat=False,
)
