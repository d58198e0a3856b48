"""Architecture registry: id -> (full config, smoke config).

The paper's dense LLaMA configs and mamba2-370m (the ssm family) are
ported; the other architectures of the JAX package's registry come with
their model families.
"""
from __future__ import annotations

from repro_torch.configs import llama_paper, mamba2_370m
from repro_torch.configs.base import ModelConfig

_ARCHS = {
    "llama-60m": (llama_paper.LLAMA_60M, llama_paper.SMOKE),
    "llama-130m": (llama_paper.LLAMA_130M, llama_paper.SMOKE),
    "llama-350m": (llama_paper.LLAMA_350M, llama_paper.SMOKE),
    "mamba2-370m": (mamba2_370m.CONFIG, mamba2_370m.SMOKE),
}
ARCHS = tuple(_ARCHS)


def _known(arch: str) -> None:
    if arch not in _ARCHS:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; ported: {ARCHS}")


def get_config(arch: str) -> ModelConfig:
    _known(arch)
    return _ARCHS[arch][0]


def get_smoke(arch: str) -> ModelConfig:
    _known(arch)
    return _ARCHS[arch][1]
