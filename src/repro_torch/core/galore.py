"""GaLore (Zhao et al., 2024) and GoLore, Algorithm 1 of the paper, as
compositions of :mod:`repro_torch.core.combinators`::

    galore      = chain(lowrank(scale_by_adam(scale=alpha)),
                        add_decayed_weights(wd), scale_by_lr(lr))     # biased
    galore_muon = chain(lowrank(scale_by_muon(beta)),
                        add_decayed_weights(wd), scale_by_lr(lr))     # = GUM q=0
    golore      = galore with projector="random", base="sgdm" (He et al.)

routed beside AdamW for the non-matrix leaves (embeddings, norms).

  * base="adam" — the original GaLore (biased: Property II does not hold;
                  the Adam moments live in the projected space and the
                  update is back-projected).
  * base="muon" — GaLore-Muon, the paper's biased baseline.
  * base="sgdm" — GaLore with SGD momentum (through the fused low-rank
                  momentum kernel).

``projector`` is any of svd | subspace | rsvd | random | grass (``noise``
replaces the projector's random draws, see ``lowrank``).
``pad_rank_to`` pads the rank axis of the dispatched ops (see
``kernels/dispatch.py``).  ``fuse_families`` runs the projected pipeline
once per shape family;
``fused_epilogue`` folds ``-lr``, ``wd`` and the back-projection into one
``back_project_epilogue`` launch per family.  ``kernel_impl`` ("auto" |
"cuda" | "torch") routes the hot ops through the CUDA kernels on CUDA
tensors.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.adamw import adamw
from repro_torch.core.api import Schedule, Transform
from repro_torch.core.combinators import (
    add_decayed_weights,
    chain,
    lowrank,
    scale_by_adam,
    scale_by_lr,
    scale_by_momentum,
    scale_by_muon,
    with_matrix_routing,
)
from repro_torch.core.lowrank_common import Noise, default_lowrank_filter


def galore_matrices(
    lr: Schedule,
    rank=128,
    period: int = 200,
    projector: str = "svd",
    base: str = "adam",
    beta: float = 0.95,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    scale: float = 0.25,
    ns_steps: int = 5,
    weight_decay: float = 0.0,
    reset_on_update: bool = False,
    seed: int = 0,
    subspace_iters: int = 2,
    kernel_impl: str = "auto",
    pad_rank_to: int = 0,
    fuse_families: bool = False,
    fused_epilogue: bool = False,
    noise: Optional[Noise] = None,
    rank_policy=None,
    telemetry: bool = False,
) -> Transform:
    """GaLore over matrix leaves only (route others via :func:`galore`).
    ``rank`` is an int or a per-shape ``RankMap``; ``rank_policy`` goes to
    ``lowrank``."""
    if base == "adam":
        inner = scale_by_adam(b1=b1, b2=b2, eps=eps, scale=scale)
    elif base == "muon":
        inner = scale_by_muon(beta=beta, ns_steps=ns_steps, kernel_impl=kernel_impl)
    elif base == "sgdm":
        inner = scale_by_momentum(beta=beta)
    else:
        raise ValueError(f"unsupported base: {base}")
    return chain(
        lowrank(inner, rank=rank, period=period, projector=projector, seed=seed,
                subspace_iters=subspace_iters, reset_on_refresh=reset_on_update,
                kernel_impl=kernel_impl, pad_rank_to=pad_rank_to,
                fuse_families=fuse_families,
                fused_epilogue=fused_epilogue, noise=noise, rank_policy=rank_policy,
                telemetry=telemetry),
        add_decayed_weights(weight_decay),
        scale_by_lr(lr),
    )


def galore(
    lr: Schedule,
    rank=128,
    period: int = 200,
    projector: str = "svd",
    base: str = "adam",
    lowrank_filter: Callable[[str, torch.Tensor], bool] = default_lowrank_filter,
    **kw,
) -> Transform:
    """Full GaLore: low-rank on hidden matrices, AdamW elsewhere."""
    return with_matrix_routing(
        galore_matrices(lr, rank=rank, period=period, projector=projector, base=base,
                        **kw),
        adamw(lr, weight_decay=kw.get("weight_decay", 0.0)),
        matrix_filter=lowrank_filter,
        matrix_label="galore",
    )


def golore(lr: Schedule, rank=128, period: int = 200, base: str = "sgdm",
           **kw) -> Transform:
    """GoLore (He et al., 2024): GaLore with a gradient-independent random
    orthonormal projector — convergent but blind to the gradient's subspace."""
    return galore(lr, rank=rank, period=period, projector="random", base=base, **kw)
