"""The paper's own pre-training architectures (Table 4): LLaMA 60M/130M/350M,
standard GaLore-paper configs (Zhao et al., 2024 Table 12), context 1024.
"""
from repro_torch.configs.base import ModelConfig

_COMMON = dict(
    family="dense", act="swiglu", rope="rope", vocab=32000,
    tie_embeddings=True, dtype="float32", max_seq=1024,
)

LLAMA_60M = ModelConfig(
    name="llama-60m", n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=1376, **_COMMON,
)
LLAMA_130M = ModelConfig(
    name="llama-130m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=2048, **_COMMON,
)
LLAMA_350M = ModelConfig(
    name="llama-350m", n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2736, **_COMMON,
)

CONFIG = LLAMA_130M
SMOKE = LLAMA_60M.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab=256, remat=False)
