"""The train, prefill and serve steps (the port of the JAX package's
``launch/steps.py``: ``make_train_step`` at ``microbatches=1``,
``make_prefill_step`` and ``make_serve_step``)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.api import Transform, clip_by_global_norm, global_norm
from repro_torch.models.transformer import Transformer, check_logit_chunk, lm_loss


def make_train_step(model: Transformer, optimizer: Transform, *,
                    grad_clip: float = 0.0, microbatches: int = 1) -> Callable:
    """``(params, opt_state, batch) -> (opt_state, metrics)``.

    ``params`` is ``model.params()``, updated **in place** (``p += u`` under
    ``no_grad``, so no second copy of the weights exists); the optimizer
    itself is functional.  **NaN/Inf guard:** when the loss or the (clipped)
    gradient norm is not finite the step applies no update and returns the
    old optimizer state (``update_applied=False``) — the outcome of the
    reference's in-jit guard, decided on the host from one synchronising
    read per step.  ``cfg.logit_chunk > 0`` raises (the chunked loss is not
    ported yet).
    """
    if microbatches != 1:
        raise NotImplementedError("gradient accumulation (microbatches > 1) is "
                                  "not ported yet")
    check_logit_chunk(model.cfg)

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


def make_prefill_step(model) -> Callable:
    """``batch -> (logits, cache)``: the forward pass of an inference
    prefill, with the populated KV cache for the attention families and None
    for the ssm family (whose prefill builds no decode cache, as in the
    reference).  Runs without autograd, so the forward-only kernels run."""
    want_cache = model.cfg.family in ("dense", "moe", "vlm")

    @torch.no_grad()
    def prefill_step(batch: dict):
        logits, cache = model(batch["tokens"], return_cache=True)
        return logits, (cache if want_cache else None)

    return prefill_step


def make_serve_step(model) -> Callable:
    """``(cache, tokens (B, 1), pos) -> (logits, cache)``: one decode step,
    ``pos`` an int or one position per row; the cache is updated in place."""

    @torch.no_grad()
    def serve_step(cache: dict, tokens: torch.Tensor, pos):
        return model.decode_step(cache, tokens, pos)

    return serve_step
