"""Architecture registry: id -> (full config, smoke config).

Every architecture of the JAX package's registry, under its id: the paper's
dense LLaMA configs, the dense variants (chatglm3-6b, qwen1.5-4b,
starcoder2-7b, nemotron-4-340b), mamba2-370m (ssm), the moe family
(dbrx-132b, llama4-maverick-400b-a17b), zamba2-1.2b (hybrid),
llama-3.2-vision-11b (vlm) and hubert-xlarge (audio).
"""
from __future__ import annotations

from repro_torch.configs import (
    chatglm3_6b,
    dbrx_132b,
    hubert_xlarge,
    llama4_maverick_400b,
    llama_3_2_vision_11b,
    llama_paper,
    mamba2_370m,
    nemotron_4_340b,
    qwen1_5_4b,
    starcoder2_7b,
    zamba2_1_2b,
)
from repro_torch.configs.base import ModelConfig

_ARCHS = {
    "llama-60m": (llama_paper.LLAMA_60M, llama_paper.SMOKE),
    "llama-130m": (llama_paper.LLAMA_130M, llama_paper.SMOKE),
    "llama-350m": (llama_paper.LLAMA_350M, llama_paper.SMOKE),
    "chatglm3-6b": (chatglm3_6b.CONFIG, chatglm3_6b.SMOKE),
    "qwen1.5-4b": (qwen1_5_4b.CONFIG, qwen1_5_4b.SMOKE),
    "starcoder2-7b": (starcoder2_7b.CONFIG, starcoder2_7b.SMOKE),
    "nemotron-4-340b": (nemotron_4_340b.CONFIG, nemotron_4_340b.SMOKE),
    "mamba2-370m": (mamba2_370m.CONFIG, mamba2_370m.SMOKE),
    "dbrx-132b": (dbrx_132b.CONFIG, dbrx_132b.SMOKE),
    "llama4-maverick-400b-a17b": (llama4_maverick_400b.CONFIG, llama4_maverick_400b.SMOKE),
    "zamba2-1.2b": (zamba2_1_2b.CONFIG, zamba2_1_2b.SMOKE),
    "llama-3.2-vision-11b": (llama_3_2_vision_11b.CONFIG, llama_3_2_vision_11b.SMOKE),
    "hubert-xlarge": (hubert_xlarge.CONFIG, hubert_xlarge.SMOKE),
}
ARCHS = tuple(_ARCHS)


def _known(arch: str) -> None:
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")


def get_config(arch: str) -> ModelConfig:
    _known(arch)
    return _ARCHS[arch][0]


def get_smoke(arch: str) -> ModelConfig:
    _known(arch)
    return _ARCHS[arch][1]
