"""The train step: loss, autograd gradients, global-norm clipping, the
NaN/Inf guard and the optimizer update (the port of the JAX package's
``launch/steps.py::make_train_step``, ``microbatches=1``)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.api import Transform, clip_by_global_norm, global_norm
from repro_torch.models.transformer import Transformer, lm_loss


def make_train_step(model: Transformer, optimizer: Transform, *,
                    grad_clip: float = 0.0, microbatches: int = 1) -> Callable:
    """``(params, opt_state, batch) -> (opt_state, metrics)``.

    ``params`` is ``model.params()``, updated **in place** (``p += u`` under
    ``no_grad``, so no second copy of the weights exists); the optimizer
    itself is functional.  **NaN/Inf guard:** when the loss or the (clipped)
    gradient norm is not finite the step applies no update and returns the
    old optimizer state (``update_applied=False``) — the outcome of the
    reference's in-jit guard, decided on the host from one synchronising
    read per step.
    """
    if microbatches != 1:
        raise NotImplementedError("gradient accumulation (microbatches > 1) is "
                                  "not ported yet")

    def train_step(params: dict, opt_state, batch: dict):
        tokens = batch["tokens"]
        loss = lm_loss(model(tokens), tokens)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        if grad_clip > 0:
            grads = clip_by_global_norm(grads, grad_clip)
        gnorm = global_norm(grads)
        finite = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
        if finite:
            with torch.no_grad():
                updates, opt_state = optimizer.update(
                    grads, opt_state, {k: p.detach() for k, p in params.items()})
                for k, p in params.items():
                    if updates[k] is not None:
                        p.add_(updates[k].to(p.dtype))
        metrics = {"loss": loss.detach(), "grad_norm": gnorm, "update_applied": finite}
        return opt_state, metrics

    return train_step
