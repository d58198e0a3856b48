"""Fira (Chen et al., 2024): full-rank training under a low-rank constraint,
as a composition of :mod:`repro_torch.core.combinators`::

    fira = chain(lowrank(with_fira_residual(scale_by_adam())),
                 scale_by_factor(alpha), scale_by_lr(lr))

routed beside AdamW.  GaLore-Adam plus the part of the gradient outside the
projected subspace, scaled per block by the ratio of the low-rank Adam
update's norm to the projected gradient's, with Fira's norm-growth limiter.
No unbiasedness guarantee (the paper's point of comparison).  Per leaf and
step it projects once and back-projects twice, through the kernel dispatch
layer (``kernel_impl``); the Adam moments and the residual are elementwise.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.adamw import adamw
from repro_torch.core.api import Schedule, Transform
from repro_torch.core.combinators import (
    chain,
    lowrank,
    scale_by_adam,
    scale_by_factor,
    scale_by_lr,
    with_fira_residual,
    with_matrix_routing,
)
from repro_torch.core.lowrank_common import Noise, default_lowrank_filter


def fira_matrices(
    lr: Schedule,
    rank=128,
    period: int = 200,
    projector: str = "svd",
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    scale: float = 0.25,
    limiter: float = 1.01,
    seed: int = 0,
    kernel_impl: str = "auto",
    pad_rank_to: int = 0,
    noise: Optional[Noise] = None,
    fuse_families: bool = False,
    fused_epilogue: bool = False,
    rank_policy=None,
    telemetry: bool = False,
) -> Transform:
    """Fira over matrix leaves only (route others via :func:`fira`).
    ``rank`` is an int or a per-shape ``RankMap``; ``rank_policy`` goes to
    ``lowrank``."""
    return chain(
        lowrank(
            with_fira_residual(scale_by_adam(b1=b1, b2=b2, eps=eps), limiter=limiter,
                               eps=eps),
            rank=rank, period=period, projector=projector, seed=seed,
            kernel_impl=kernel_impl, pad_rank_to=pad_rank_to, fuse_families=fuse_families,
            fused_epilogue=fused_epilogue, noise=noise, rank_policy=rank_policy,
            telemetry=telemetry,
        ),
        scale_by_factor(scale),
        scale_by_lr(lr),
    )


def fira(
    lr: Schedule,
    rank=128,
    period: int = 200,
    lowrank_filter: Callable[[str, torch.Tensor], bool] = default_lowrank_filter,
    **kw,
) -> Transform:
    """Full Fira: on hidden matrices, AdamW elsewhere."""
    return with_matrix_routing(
        fira_matrices(lr, rank=rank, period=period, **kw),
        adamw(lr),
        matrix_filter=lowrank_filter,
        matrix_label="fira",
    )
