"""Algorithm 3 — the general unbiased low-rank paradigm, exact Bernoulli form.

The reference semantics: each block independently draws xi ~ Bernoulli(q)
every period and keeps a full ``(m, n)`` momentum (memory-naive).  It is
what the theory tests check (Lemma 1/2: one step against the base driven
by the unbiased estimator Ĝ), and the form of the synthetic experiments.
The production, memory-efficient fixed-count form is
:mod:`repro_torch.core.gum`.

Per period and leaf ``i`` the key is ``(seed, (count - 1) // period, i)``:
the projector's draws are ``noise(key, "normal" | "gumbel", shape)`` and
xi is ``noise(key, "uniform", lead) < q`` — the reference splits its key
into a projector half and a Bernoulli half, which a parity test's injected
noise tells apart by kind.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.api import Schedule, Transform, schedule_value
from repro_torch.core.lowrank_common import (
    Noise,
    compute_projectors,
    family_shape,
    generator_noise,
    proj_shape,
)
from repro_torch.kernels import dispatch


class UnbiasedFamilyState(NamedTuple):
    p: torch.Tensor     # (*lead, s, r)
    mom: torch.Tensor   # (*lead, m, n) full-shape momentum
    xi: torch.Tensor    # (*lead,) bool — full-rank this period?


class UnbiasedState(NamedTuple):
    count: int
    families: dict


def unbiased_lowrank(
    lr: Schedule,
    rank: int,
    q: float,
    period: int = 1,
    projector: str = "svd",
    base: str = "muon",
    beta: float = 0.95,
    ns_steps: int = 5,
    compensation: str = "paper",
    seed: int = 0,
    kernel_impl: str = "auto",
    noise: Optional[Noise] = None,
) -> Transform:
    """Ĝ = c_full (G − c_comp P Pᵀ G) where xi, else c_low P Pᵀ G; momentum
    ``beta mom + Ĝ``; the update ``-lr NS(mom)`` (``base="muon"``) or
    ``-lr mom`` (``"sgdm"``).  Coefficients as in
    :func:`~repro_torch.core.combinators.layerwise_unbias`."""
    if base not in ("muon", "sgdm"):
        raise ValueError("Property II requires base in {muon, sgdm}")
    if not 0.0 < q < 1.0:
        raise ValueError("Bernoulli unbiased form needs 0 < q < 1")
    noise = noise or generator_noise
    c_low = 1.0 if compensation == "finetune" else 1.0 / (1.0 - q)
    c_comp = (1.0 - q) if compensation == "finetune" else 1.0
    c_full = 1.0 / q

    def init(params: dict) -> UnbiasedState:
        fams = {}
        for k, p in params.items():
            fs = family_shape(p, rank)
            fams[k] = UnbiasedFamilyState(
                p=torch.zeros(proj_shape(fs), dtype=torch.float32, device=p.device),
                mom=torch.zeros(fs.lead + (fs.m, fs.n), dtype=torch.float32,
                                device=p.device),
                xi=torch.zeros(fs.lead, dtype=torch.bool, device=p.device))
        return UnbiasedState(count=0, families=fams)

    def update(grads: dict, state: UnbiasedState, params: dict):
        count = state.count + 1
        step_lr = schedule_value(lr, count)
        refresh = (count - 1) % period == 0
        upds, fams = {}, {}
        for i, (k, p) in enumerate(params.items()):
            fs, st = family_shape(p, rank), state.families[k]
            g = grads[k].to(torch.float32)
            p_proj, xi, mom = st.p, st.xi, st.mom
            if refresh:
                key = (seed, (count - 1) // period, i)
                p_proj = compute_projectors(projector, g, fs.rank, fs.side, key=key,
                                            noise=noise)
                xi = noise(key, "uniform", fs.lead).to(g.device) < q
                mom = torch.zeros_like(mom)
            pptg = dispatch.back_project(
                p_proj, dispatch.project(p_proj, g, side=fs.side, impl=kernel_impl),
                side=fs.side, impl=kernel_impl)
            g_hat = torch.where(xi[..., None, None], c_full * (g - c_comp * pptg),
                                c_low * pptg)
            mom = beta * mom + g_hat
            upd = (dispatch.newton_schulz(mom, steps=ns_steps, impl=kernel_impl)
                   if base == "muon" else mom)
            upds[k] = -step_lr * upd
            fams[k] = UnbiasedFamilyState(p=p_proj, mom=mom, xi=xi)
        return upds, UnbiasedState(count=count, families=fams)

    return Transform(init, update)
