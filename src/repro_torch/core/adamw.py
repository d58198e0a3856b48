"""AdamW and SGDM — the paper's full-rank baselines; AdamW is also the
optimizer of the leaves the low-rank methods do not project (embeddings,
norms)::

    adamw = chain(scale_by_adam(b1, b2, eps), add_decayed_weights(wd),
                  scale_by_lr(lr))
    sgdm  = chain(scale_by_momentum(beta), add_decayed_weights(wd),
                  scale_by_lr(lr))
"""
from __future__ import annotations

from repro_torch.core.api import Schedule, Transform
from repro_torch.core.combinators import (
    add_decayed_weights,
    chain,
    scale_by_adam,
    scale_by_lr,
    scale_by_momentum,
)


def adamw(
    lr: Schedule,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Transform:
    """AdamW (decoupled weight decay)."""
    return chain(
        scale_by_adam(b1=b1, b2=b2, eps=eps),
        add_decayed_weights(weight_decay),
        scale_by_lr(lr),
    )


def sgdm(lr: Schedule, beta: float = 0.9, weight_decay: float = 0.0) -> Transform:
    """SGD with EMA momentum — a Property-II compliant base."""
    return chain(
        scale_by_momentum(beta=beta),
        add_decayed_weights(weight_decay),
        scale_by_lr(lr),
    )
