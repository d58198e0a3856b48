"""LISA (Pan et al., 2024): layerwise importance sampling.

Each period, ``gamma`` blocks of every layer-stacked family are sampled and
only they train (full AdamW); the other blocks are frozen — their
gradients and their updates are zeroed (AdamW's moments of a frozen block
still decay).  Embeddings, norms and the head always train.  The baseline
that GUM's full-rank branch descends from.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.adamw import adamw
from repro_torch.core.api import PyTree, Schedule, Transform
from repro_torch.core.combinators import Sampler, generator_sampler
from repro_torch.core.lowrank_common import default_lowrank_filter, family_shape


class LISAState(NamedTuple):
    count: int
    inner: PyTree   # AdamW state over all params
    masks: dict     # per-leaf bool (*lead,) (or (1,)) active blocks; None = always trained


def lisa(
    lr: Schedule,
    gamma: int = 2,
    period: int = 200,
    seed: int = 0,
    layer_filter: Callable[[str, torch.Tensor], bool] = default_lowrank_filter,
    sampler: Optional[Sampler] = None,
    **adam_kw,
) -> Transform:
    """``sampler(key, L, g_f)`` draws each family's active blocks (default
    :func:`~repro_torch.core.combinators.generator_sampler`) with ``key =
    (seed, period index, leaf index)`` — the reference folds those into
    its key, with no split."""
    base = adamw(lr, **adam_kw)
    sampler = sampler or generator_sampler

    def init(params: dict) -> LISAState:
        masks = {}
        for k, p in params.items():
            if p is None or not layer_filter(k, p):
                masks[k] = None
                continue
            lead = family_shape(p, rank=1).lead
            masks[k] = torch.zeros(lead or (1,), dtype=torch.bool, device=p.device)
        return LISAState(count=0, inner=base.init(params), masks=masks)

    def _apply(tree: dict, masks: dict) -> dict:
        """Zero the frozen blocks of every masked leaf."""
        out = {}
        for k, x in tree.items():
            mask = masks.get(k)
            if x is None or mask is None:
                out[k] = x
                continue
            mm = mask.reshape(tuple(mask.shape) + (1, 1)) if x.dim() > 2 else mask.reshape(())
            out[k] = x * mm.to(x.dtype)
        return out

    def update(grads: dict, state: LISAState, params: dict):
        count = state.count + 1
        refresh = (count - 1) % period == 0
        masks = state.masks
        if refresh:
            masks = {}
            for i, (k, mask) in enumerate(state.masks.items()):
                if mask is None:
                    masks[k] = None
                    continue
                L = mask.numel()
                if mask.device.type == "meta":  # a shape-only trace: no draw
                    masks[k] = torch.empty_like(mask)
                    continue
                idx = sampler((seed, (count - 1) // period, i), L, min(gamma, L))
                fresh = torch.zeros(L, dtype=torch.bool)
                fresh[idx.to(torch.long)] = True
                masks[k] = fresh.reshape(mask.shape).to(mask.device)
        updates, inner = base.update(_apply(grads, masks), state.inner, params)
        return _apply(updates, masks), LISAState(count=count, inner=inner, masks=masks)

    update.chain_info = {"kind": "lisa", "gamma": gamma, "period": period,
                         "inner": dict(getattr(base.update, "chain_info", None)
                                       or {"kind": "opaque"})}
    return Transform(init, update)
