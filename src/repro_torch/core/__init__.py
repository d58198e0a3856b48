"""Optimizer core: the functional Transform API, the combinators, the
family plan, GUM, GaLore and AdamW, and the factory."""
from repro_torch.core.api import (
    MultiState,
    OptimizerConfig,
    Transform,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    multi_transform,
    tree_paths,
)
from repro_torch.core.combinators import (
    LayerwiseUnbiasState,
    LowRankState,
    generator_sampler,
)
from repro_torch.core.factory import build_optimizer
from repro_torch.core.lowrank_common import default_lowrank_filter

__all__ = [
    "LayerwiseUnbiasState", "LowRankState", "MultiState", "OptimizerConfig",
    "Transform", "apply_updates", "build_optimizer", "clip_by_global_norm",
    "default_lowrank_filter", "generator_sampler",
    "global_norm", "multi_transform", "tree_paths",
]
