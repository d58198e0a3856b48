"""Architecture registry: id -> (full config, smoke config).

Only the paper's dense LLaMA configs are ported so far; the other
architectures of the JAX package's registry come with their model families.
"""
from __future__ import annotations

from repro_torch.configs import llama_paper
from repro_torch.configs.base import ModelConfig

_PAPER = {
    "llama-60m": llama_paper.LLAMA_60M,
    "llama-130m": llama_paper.LLAMA_130M,
    "llama-350m": llama_paper.LLAMA_350M,
}
ARCHS = tuple(_PAPER)


def _known(arch: str) -> None:
    if arch not in _PAPER:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; ported: {ARCHS}")


def get_config(arch: str) -> ModelConfig:
    _known(arch)
    return _PAPER[arch]


def get_smoke(arch: str) -> ModelConfig:
    _known(arch)
    return llama_paper.SMOKE
