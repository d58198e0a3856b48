"""AdamW — the paper's full-rank baseline, and GUM's optimizer for the
leaves it does not project (embeddings, norms)::

    adamw = chain(scale_by_adam(b1, b2, eps), add_decayed_weights(wd),
                  scale_by_lr(lr))
"""
from __future__ import annotations

from repro_torch.core.api import Schedule, Transform
from repro_torch.core.combinators import (
    add_decayed_weights,
    chain,
    scale_by_adam,
    scale_by_lr,
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
