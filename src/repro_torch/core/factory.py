"""Optimizer factory: OptimizerConfig -> combinator-composed Transform.

Ported names: ``gum``, ``galore``, ``galore_muon`` and ``adamw``.  The JAX
package's other optimizers (golore, muon, sgdm, fira, lisa,
unbiased_galore_adam) raise ``NotImplementedError`` until they are ported
(see ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.adamw import adamw
from repro_torch.core.api import OptimizerConfig, Transform
from repro_torch.core.combinators import Sampler
from repro_torch.core.galore import galore
from repro_torch.core.gum import gum

NOT_PORTED = ("sgdm", "muon", "golore", "unbiased_galore_adam", "fira", "lisa")


def build_optimizer(cfg: OptimizerConfig, *,
                    sampler: Optional[Sampler] = None) -> Transform:
    """``sampler`` replaces GUM's block sampler (tests inject the reference's
    sampled blocks through it)."""
    name = cfg.name.lower()
    fusion = {"fuse_families": cfg.fuse_families, "fused_epilogue": cfg.fused_epilogue}
    if name == "adamw":
        return adamw(cfg.lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                     weight_decay=cfg.weight_decay)
    if name == "gum":
        return gum(
            cfg.lr, rank=cfg.rank, gamma=cfg.gamma, period=cfg.period,
            projector=cfg.projector, base=cfg.base, beta=cfg.beta,
            ns_steps=cfg.ns_steps, weight_decay=cfg.weight_decay,
            compensation=cfg.compensation, seed=cfg.seed,
            kernel_impl=cfg.kernel_impl, sampler=sampler, **fusion,
        )
    if name == "galore":
        return galore(cfg.lr, rank=cfg.rank, period=cfg.period, projector=cfg.projector,
                      base="adam", weight_decay=cfg.weight_decay, seed=cfg.seed,
                      kernel_impl=cfg.kernel_impl, **fusion)
    if name == "galore_muon":
        return galore(cfg.lr, rank=cfg.rank, period=cfg.period, projector=cfg.projector,
                      base="muon", beta=cfg.beta, ns_steps=cfg.ns_steps,
                      weight_decay=cfg.weight_decay, seed=cfg.seed,
                      kernel_impl=cfg.kernel_impl, **fusion)
    if name in NOT_PORTED:
        raise NotImplementedError(f"optimizer {cfg.name!r} is not ported yet")
    raise ValueError(f"unknown optimizer: {cfg.name!r}")
