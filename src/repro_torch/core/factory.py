"""Optimizer factory: OptimizerConfig -> combinator-composed Transform.

Every name the JAX package's factory builds: ``adamw``, ``sgdm``, ``muon``,
``galore``, ``galore_muon``, ``golore``, ``gum``, ``unbiased_galore_adam``,
``fira`` and ``lisa``, each composed as the reference's ``_compose`` does
(the same arguments forwarded, the same defaults left).  The knobs the port
does not run yet raise in ``OptimizerConfig`` (``core/api.py``).
``audit=True`` runs the chain linter
(:func:`repro_torch.analysis.chain_lint.lint_chain`) on the composed chain
and raises :class:`repro_torch.analysis.chain_lint.ChainLintError` on an
error finding, as the reference's factory does.

``cfg.rank_policy`` / ``cfg.rank_ladder`` (see
:mod:`repro_torch.core.rank_policy`) make rank a per-family, time-varying
quantity: the policy supplies the initial ``RankMap`` (and spectrum probing
for adaptive policies); a live run's ``RankPolicyController`` rebuilds the
chain at each new assignment through :func:`build_optimizer`'s
``rank_map``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.adamw import adamw, sgdm
from repro_torch.core.api import OptimizerConfig, Transform
from repro_torch.core.combinators import Sampler
from repro_torch.core.fira import fira
from repro_torch.core.galore import galore, golore
from repro_torch.core.gum import gum, unbiased_galore_adam
from repro_torch.core.lisa import lisa
from repro_torch.core.lowrank_common import Noise
from repro_torch.core.muon import muon
from repro_torch.core.rank_policy import RankMap, RankPolicy, as_policy


def resolve_rank_policy(cfg: OptimizerConfig) -> Optional[RankPolicy]:
    """``cfg.rank_policy`` (None | spec string | RankPolicy) resolved to a
    policy object, with ``cfg.rank_ladder`` / ``cfg.rank`` as the ladder
    bounds for adaptive specs."""
    ladder = tuple(cfg.rank_ladder or ())
    return as_policy(
        cfg.rank_policy, ladder=ladder,
        r_min=min(ladder) if ladder else 8,
        r_max=max(ladder) if ladder else max(int(cfg.rank), 8),
    )


def build_optimizer(cfg: OptimizerConfig, rank_map: Optional[RankMap] = None, *,
                    audit: bool = False, sampler: Optional[Sampler] = None,
                    noise: Optional[Noise] = None) -> Transform:
    """``rank_map`` overrides the rank assignment for this build — the
    ``RankPolicyController``'s re-entry point (``lambda m:
    build_optimizer(cfg, rank_map=m)``); without it the rank is ``cfg.rank``
    (or the policy's initial map when one is configured).  ``sampler``
    replaces the block sampler of GUM, unbiased GaLore-Adam and LISA,
    ``noise`` the projectors' random draws (tests inject the reference's
    draws through them).  ``audit=True`` lints the composed chain and raises
    :class:`~repro_torch.analysis.chain_lint.ChainLintError` on an error
    finding: a malformed composition fails here with a lint code and a
    fix-it hint instead of a TypeError mid-step."""
    opt = _build(cfg, rank_map, sampler, noise)
    if audit:
        # Lazy import: repro_torch.analysis sits on top of this module.
        from repro_torch.analysis.chain_lint import ChainLintError, lint_chain

        errors = [f for f in lint_chain(opt, ladder=cfg.rank_ladder, name=cfg.name.lower())
                  if f.severity == "error"]
        if errors:
            raise ChainLintError(errors)
    return opt


def _build(cfg: OptimizerConfig, rank_map: Optional[RankMap], sampler: Optional[Sampler],
           noise: Optional[Noise]) -> Transform:
    name = cfg.name.lower()
    fusion = {"fuse_families": cfg.fuse_families, "fused_epilogue": cfg.fused_epilogue,
              "telemetry": cfg.telemetry}
    rank = rank_map if rank_map is not None else cfg.rank
    lowrank_kw = {"rank": rank, "rank_policy": resolve_rank_policy(cfg), "seed": cfg.seed,
                  "kernel_impl": cfg.kernel_impl, "pad_rank_to": cfg.pad_rank_to,
                  "noise": noise, **fusion}
    muon_scale = {} if cfg.use_muon_scale is None else {"use_muon_scale": cfg.use_muon_scale}
    if name == "adamw":
        return adamw(cfg.lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                     weight_decay=cfg.weight_decay)
    if name == "sgdm":
        return sgdm(cfg.lr, beta=cfg.beta, weight_decay=cfg.weight_decay)
    if name == "muon":
        return muon(cfg.lr, beta=cfg.beta, weight_decay=cfg.weight_decay,
                    ns_steps=cfg.ns_steps, kernel_impl=cfg.kernel_impl, **muon_scale)
    if name in ("galore", "galore_muon"):
        base = {"galore": {"base": "adam"},
                "galore_muon": {"base": "muon", "beta": cfg.beta, "ns_steps": cfg.ns_steps}}
        return galore(cfg.lr, period=cfg.period, projector=cfg.projector,
                      weight_decay=cfg.weight_decay, **base[name], **lowrank_kw)
    if name == "golore":
        return golore(cfg.lr, period=cfg.period, base=cfg.base, **lowrank_kw)
    if name == "gum":
        return gum(
            cfg.lr, gamma=cfg.gamma, period=cfg.period,
            projector=cfg.projector, base=cfg.base, beta=cfg.beta,
            ns_steps=cfg.ns_steps, weight_decay=cfg.weight_decay,
            compensation=cfg.compensation, sampler=sampler, **lowrank_kw, **muon_scale,
        )
    if name == "unbiased_galore_adam":
        return unbiased_galore_adam(
            cfg.lr, gamma=cfg.gamma, period=cfg.period,
            projector=cfg.projector, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
            weight_decay=cfg.weight_decay, compensation=cfg.compensation,
            sampler=sampler, **lowrank_kw,
        )
    if name == "fira":
        return fira(cfg.lr, period=cfg.period, **lowrank_kw)
    if name == "lisa":
        return lisa(cfg.lr, gamma=cfg.gamma, period=cfg.period, seed=cfg.seed,
                    sampler=sampler)
    raise ValueError(f"unknown optimizer: {cfg.name!r}")
