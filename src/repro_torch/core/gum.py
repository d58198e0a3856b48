"""GUM — GaLore Unbiased with Muon (Algorithm 2 of the paper), as a
composition of :mod:`repro_torch.core.combinators`::

    gum_matrices = chain(
        lowrank(layerwise_unbias(scale_by_muon(beta), gamma, compensation),
                rank, period, projector, reset_on_refresh=True),
        add_decayed_weights(wd), scale_by_lr(lr))
    gum = with_matrix_routing(gum_matrices, adamw)

Every ``period`` steps, ``gamma`` blocks of each layer-stacked family are
sampled to run the compensated full-rank Muon update; the rest run the scaled
low-rank Muon update (see ``layerwise_unbias``).  Update rules (left side,
block l):

  low-rank (unsampled):  R_l <- beta R_l + c_low  * P_lᵀ G_l
                         W_l <- W_l - lr * P_l NS(R_l)
  full-rank (sampled):   F_j <- beta F_j + c_full * (G_l - c_comp P_l P_lᵀ G_l)
                         W_l <- W_l - lr * NS(F_j)

``base="sgdm"`` runs the momentum without Newton–Schulz (both bases are
Property-II compliant); ``use_muon_scale`` multiplies both branches'
updates by Muon's sqrt(max(1, m/n)) (off by default: Algorithm 2 does not
scale).  ``projector`` is any of svd | subspace | rsvd | random | grass.
``kernel_impl`` ("auto" | "cuda" | "torch") routes the momentum update, the
projections and Newton–Schulz through the CUDA kernels on CUDA tensors.
``fuse_families`` runs the pipeline once per shape family (sampling stays
per member leaf); ``fused_epilogue`` is accepted and inert, since
``layerwise_unbias`` emits full-shape updates.
``sampler`` replaces the block sampler (see
:func:`repro_torch.core.combinators.generator_sampler`) and ``noise`` the
projector's random draws (see
:func:`repro_torch.core.lowrank_common.generator_noise`).

:func:`unbiased_galore_adam` is the same debiasing around ``scale_by_adam``:
its gradient estimate is unbiased (Lemma 1), though Adam breaks Property II.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.adamw import adamw
from repro_torch.core.api import Schedule, Transform
from repro_torch.core.combinators import (
    Sampler,
    add_decayed_weights,
    chain,
    layerwise_unbias,
    lowrank,
    scale_by_adam,
    scale_by_lr,
    scale_by_momentum,
    scale_by_muon,
    with_matrix_routing,
)
from repro_torch.core.lowrank_common import Noise, default_lowrank_filter


def gum_matrices(
    lr: Schedule,
    rank: int = 128,
    gamma: int = 2,
    period: int = 200,
    projector: str = "svd",
    base: str = "muon",
    beta: float = 0.95,
    ns_steps: int = 5,
    weight_decay: float = 0.0,
    compensation: str = "paper",
    seed: int = 0,
    subspace_iters: int = 2,
    kernel_impl: str = "auto",
    use_muon_scale: bool = False,
    sampler: Optional[Sampler] = None,
    noise: Optional[Noise] = None,
    fuse_families: bool = False,
    fused_epilogue: bool = False,
) -> Transform:
    """GUM over matrix leaves (route 1-D/embedding leaves via :func:`gum`)."""
    if base == "muon":
        inner = scale_by_muon(beta=beta, ns_steps=ns_steps, use_muon_scale=use_muon_scale,
                              kernel_impl=kernel_impl)
    elif base == "sgdm":
        inner = scale_by_momentum(beta=beta, use_muon_scale=use_muon_scale)
    else:
        raise ValueError("GUM requires a Property-II base optimizer: muon | sgdm")
    lowrank_t = lowrank(
        layerwise_unbias(inner, gamma=gamma, compensation=compensation,
                         sampler=sampler),
        rank=rank, period=period, projector=projector, seed=seed,
        subspace_iters=subspace_iters, reset_on_refresh=True, kernel_impl=kernel_impl,
        fuse_families=fuse_families, fused_epilogue=fused_epilogue, noise=noise,
    )
    return chain(lowrank_t, add_decayed_weights(weight_decay), scale_by_lr(lr))


def gum(
    lr: Schedule,
    rank: int = 128,
    gamma: int = 2,
    period: int = 200,
    projector: str = "svd",
    lowrank_filter: Callable[[str, torch.Tensor], bool] = default_lowrank_filter,
    **kw,
) -> Transform:
    """Full GUM: unbiased low-rank Muon on hidden matrices, AdamW elsewhere
    (embeddings / head / norms / biases), mirroring the paper's setup."""
    matrices = gum_matrices(lr, rank=rank, gamma=gamma, period=period,
                            projector=projector, **kw)
    return with_matrix_routing(
        matrices,
        adamw(lr, weight_decay=kw.get("weight_decay", 0.0)),
        matrix_filter=lowrank_filter,
        matrix_label="gum",
    )


def unbiased_galore_adam(
    lr: Schedule,
    rank: int = 128,
    gamma: int = 2,
    period: int = 200,
    projector: str = "svd",
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    scale: float = 0.25,
    weight_decay: float = 0.0,
    compensation: str = "paper",
    seed: int = 0,
    subspace_iters: int = 2,
    kernel_impl: str = "auto",
    sampler: Optional[Sampler] = None,
    noise: Optional[Noise] = None,
    fuse_families: bool = False,
    fused_epilogue: bool = False,
    lowrank_filter: Callable[[str, torch.Tensor], bool] = default_lowrank_filter,
) -> Transform:
    """Unbiased GaLore-Adam: ``layerwise_unbias(scale_by_adam)`` inside
    ``lowrank``.  The ``gamma`` sampled blocks per period run Adam on the
    compensated full-rank gradient in their own ``(gamma, m, n)`` moment
    slots; the rest run GaLore-Adam on the scaled projected gradient."""
    matrix = chain(
        lowrank(
            layerwise_unbias(scale_by_adam(b1=b1, b2=b2, eps=eps, scale=scale),
                             gamma=gamma, compensation=compensation, sampler=sampler),
            rank=rank, period=period, projector=projector, seed=seed,
            subspace_iters=subspace_iters, reset_on_refresh=True, kernel_impl=kernel_impl,
            fuse_families=fuse_families, fused_epilogue=fused_epilogue, noise=noise,
        ),
        add_decayed_weights(weight_decay),
        scale_by_lr(lr),
    )
    return with_matrix_routing(
        matrix,
        adamw(lr, weight_decay=weight_decay),
        matrix_filter=lowrank_filter,
        matrix_label="unbiased_galore_adam",
    )
