"""Muon (Jordan et al., 2024): momentum + Newton–Schulz orthogonalization,
as a composition of :mod:`repro_torch.core.combinators`::

    muon_matrices = chain(scale_by_muon(beta, ns_steps, nesterov=True,
                                        use_muon_scale), add_decayed_weights(wd),
                          scale_by_lr(lr))
    muon          = with_matrix_routing(muon_matrices, adamw)

Hidden matrices (>= 2 dims; leading axes are stacked blocks, e.g. the
layer-stacked ``(L, m, n)``) run Muon; embeddings, the head, norms and
biases run AdamW.  ``use_muon_scale`` (default on, as Jordan et al.)
multiplies the orthogonalized update by sqrt(max(1, m/n)).
``kernel_impl`` ("auto" | "cuda" | "torch") routes Newton–Schulz through
the CUDA kernels on CUDA tensors.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.adamw import adamw
from repro_torch.core.api import Schedule, Transform
from repro_torch.core.combinators import (
    add_decayed_weights,
    chain,
    scale_by_lr,
    scale_by_muon,
    with_matrix_routing,
)


def muon_matrices(
    lr: Schedule,
    beta: float = 0.95,
    weight_decay: float = 0.0,
    ns_steps: int = 5,
    nesterov: bool = True,
    use_muon_scale: bool = True,
    kernel_impl: str = "auto",
) -> Transform:
    """Muon over matrix leaves only (callers route 1-D leaves elsewhere)."""
    return chain(
        scale_by_muon(beta=beta, ns_steps=ns_steps, nesterov=nesterov,
                      use_muon_scale=use_muon_scale, kernel_impl=kernel_impl),
        add_decayed_weights(weight_decay),
        scale_by_lr(lr),
    )


def default_matrix_filter(path: str, p: torch.Tensor) -> bool:
    """Hidden-layer matrices: >= 2 dims and not an embedding/head/norm."""
    if p.dim() < 2:
        return False
    lowered = path.lower()
    return not any(k in lowered for k in ("embed", "lm_head", "norm", "scale", "bias"))


def muon(
    lr: Schedule,
    beta: float = 0.95,
    weight_decay: float = 0.0,
    ns_steps: int = 5,
    adam_lr: Optional[Schedule] = None,
    matrix_filter: Callable[[str, torch.Tensor], bool] = default_matrix_filter,
    use_muon_scale: bool = True,
    kernel_impl: str = "auto",
) -> Transform:
    """Full Muon: Muon on hidden matrices, AdamW on the rest."""
    return with_matrix_routing(
        muon_matrices(lr, beta=beta, weight_decay=weight_decay, ns_steps=ns_steps,
                      use_muon_scale=use_muon_scale, kernel_impl=kernel_impl),
        adamw(adam_lr if adam_lr is not None else lr, weight_decay=weight_decay),
        matrix_filter=matrix_filter,
        matrix_label="muon",
    )
