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
``pad_rank_to`` pads the rank axis of the dispatched ops.
``sampler`` replaces the block sampler (see
:func:`repro_torch.core.combinators.generator_sampler`) and ``noise`` the
projector's random draws (see
:func:`repro_torch.core.lowrank_common.generator_noise`).

:func:`unbiased_galore_adam` is the same debiasing around ``scale_by_adam``:
its gradient estimate is unbiased (Lemma 1), though Adam breaks Property II.

:func:`gum_accum_tools` accumulates microbatch gradients in the projected
space (beyond the paper; see its section below).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.adamw import adamw
from repro_torch.core.api import Schedule, Transform
from repro_torch.core.combinators import (
    LowRankState,
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
from repro_torch.core.family_plan import build_family_plan, unstack_family
from repro_torch.core.lowrank_common import (
    Noise,
    default_lowrank_filter,
    family_shape,
    gather_blocks,
    scatter_blocks,
)
from repro_torch.kernels import dispatch


def gum_matrices(
    lr: Schedule,
    rank=128,
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
    external_refresh: bool = False,
    kernel_impl: str = "auto",
    use_muon_scale: bool = False,
    pad_rank_to: int = 0,
    sampler: Optional[Sampler] = None,
    noise: Optional[Noise] = None,
    fuse_families: bool = False,
    fused_epilogue: bool = False,
    rank_policy=None,
    telemetry: bool = False,
) -> Transform:
    """GUM over matrix leaves (route 1-D/embedding leaves via :func:`gum`).

    ``external_refresh=True`` skips the in-update period refresh: the
    projected-space accumulation (:func:`gum_accum_tools`) refreshes against
    microbatch 0's raw gradient before it projects.  ``rank`` is an int or a
    per-shape ``RankMap``; ``rank_policy`` goes to ``lowrank``."""
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
        subspace_iters=subspace_iters, reset_on_refresh=True,
        external_refresh=external_refresh, kernel_impl=kernel_impl,
        pad_rank_to=pad_rank_to, fuse_families=fuse_families,
        fused_epilogue=fused_epilogue, noise=noise, rank_policy=rank_policy,
        telemetry=telemetry,
    )
    t = chain(lowrank_t, add_decayed_weights(weight_decay), scale_by_lr(lr))
    # For gum_accum_tools: the lowrank stage (its external-refresh hook),
    # whose state sits at chain position 0.
    t.update.lowrank_transform = lowrank_t
    return t


def gum(
    lr: Schedule,
    rank=128,
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
    t = with_matrix_routing(
        matrices,
        adamw(lr, weight_decay=kw.get("weight_decay", 0.0)),
        matrix_filter=lowrank_filter,
        matrix_label="gum",
    )
    t.update.lowrank_transform = matrices.update.lowrank_transform
    return t


def unbiased_galore_adam(
    lr: Schedule,
    rank=128,
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
    pad_rank_to: int = 0,
    sampler: Optional[Sampler] = None,
    noise: Optional[Noise] = None,
    fuse_families: bool = False,
    fused_epilogue: bool = False,
    lowrank_filter: Callable[[str, torch.Tensor], bool] = default_lowrank_filter,
    rank_policy=None,
    telemetry: bool = False,
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
            pad_rank_to=pad_rank_to, fuse_families=fuse_families,
            fused_epilogue=fused_epilogue, noise=noise, rank_policy=rank_policy,
            telemetry=telemetry,
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


# ---------------------------------------------------------------------------
# Gradient accumulation in the projected space (beyond the paper).
#
# Projection is linear, so sum_mb Pᵀ G_mb == Pᵀ (sum_mb G_mb): a low-rank
# leaf accumulates Pᵀ G (*lead, r, n) plus its gamma sampled full blocks in
# place of a (*lead, m, n) fp32 gradient.  GUM's update reads the gradient
# only through Pᵀ G (the low-rank branch) and G[idx] (the sampled blocks), and
# with Property I project(P, back_project(P, acc_low)) == acc_low, so
#     G_hat = scatter(back_project(P, acc_low), idx, acc_full)
# fed to the standard update gives the update of the raw accumulation, up to
# rounding.  The projector refreshes from microbatch 0's raw gradient
# (Algorithm 2 builds P from one stochastic gradient anyway) through
# ``lowrank``'s external-refresh hook, so the draws stay in one place:
#
#   tools = gum_accum_tools(lr, rank=..., gamma=..., ...)
#   state = tools.transform.init(params)
#   state = tools.refresh(grads_mb0, state, params)   # on a period boundary
#   acc   = tools.project(grads_mb, state, params)    # per microbatch; summed
#   g_hat = tools.reconstruct(acc, state, params)     # compact -> full shape
#   upd, state = tools.transform.update(g_hat, state, params)
# ---------------------------------------------------------------------------


class GUMAccumTools(NamedTuple):
    transform: Transform
    refresh: Callable          # (grads, state, params) -> state
    project: Callable          # (grads, state, params) -> compact tree
    reconstruct: Callable      # (compact, state, params) -> grads tree
    refresh_reads: Callable    # (grads, state, params) -> the grads refresh
                               # reads (None elsewhere), or None off a boundary


def gum_accum_tools(
    lr: Schedule,
    rank: int = 128,
    gamma: int = 2,
    period: int = 200,
    projector: str = "svd",
    lowrank_filter: Callable[[str, torch.Tensor], bool] = default_lowrank_filter,
    seed: int = 0,
    subspace_iters: int = 2,
    kernel_impl: str = "auto",
    pad_rank_to: int = 0,
    **kw,
) -> GUMAccumTools:
    """GUM with ``external_refresh=True`` and the three hooks of the
    projected-space accumulation (``make_train_step(lowrank_accum=)``).  A
    compact leaf is ``{"low": Pᵀ G, "full": G[idx]}`` for a low-rank leaf
    (no ``"full"`` at gamma 0) and ``{"raw": G}`` (fp32) for the others;
    ``project`` and ``reconstruct`` run through the dispatched projection and
    back-projection.  Both state layouts work (``fuse_families``)."""
    fused = bool(kw.get("fuse_families"))
    transform = gum(lr, rank=rank, gamma=gamma, period=period, projector=projector,
                    lowrank_filter=lowrank_filter, seed=seed,
                    subspace_iters=subspace_iters, external_refresh=True,
                    kernel_impl=kernel_impl, pad_rank_to=pad_rank_to, **kw)
    lowrank_refresh = transform.update.lowrank_transform.update.refresh

    def labels(params: dict) -> dict:
        return {k: p is not None and lowrank_filter(k, p) for k, p in params.items()}

    def mask(tree: dict, is_low: dict) -> dict:
        return {k: v if is_low[k] else None for k, v in tree.items()}

    def _lowrank_state(state) -> LowRankState:
        # MultiState.inner["gum"] is the chain state (LowRankState, (), lr)
        return state.inner["gum"][0]

    def _per_leaf_state(lr_state: LowRankState, params: dict, is_low: dict) -> dict:
        """``{path: (projector, slot -> block ids)}`` of the low-rank leaves,
        for both layouts: a family stack's projector is unstacked per member
        and its ids shifted back to member-local blocks."""
        if not fused:
            return {k: (lr_state.projs[k], lr_state.inner.idx[k])
                    for k in params if is_low[k]}
        paths = list(params)
        plan = build_family_plan([p if is_low[k] else None for k, p in params.items()],
                                 rank)
        out = {}
        for fi, fam in enumerate(plan.families):
            projs = unstack_family(fam, lr_state.projs[fi])
            idx = lr_state.inner.idx[fi]
            g_f = idx.shape[0] // fam.seg.members if idx is not None else 0
            for j, i in enumerate(fam.members):
                member_idx = (None if idx is None
                              else idx[j * g_f:(j + 1) * g_f] - j * fam.seg.member_L)
                out[paths[i]] = (projs[j], member_idx)
        return out

    def refresh_reads(grads: dict, state, params: dict) -> Optional[dict]:
        """What ``refresh`` reads of ``grads`` at this step: the low-rank
        leaves' gradients (None at the others) on a period boundary, else
        None (the data-parallel step sends rank 0's to every rank only
        then)."""
        if (_lowrank_state(state).count % period) != 0:
            return None
        return mask(grads, labels(params))

    def refresh(grads: dict, state, params: dict):
        """The period-boundary projector refresh and block resampling against
        raw gradients, ``count`` untouched (the step's ``update`` sees the
        fresh state and never refreshes itself)."""
        is_low = labels(params)
        chain_state = tuple(state.inner["gum"])
        new_lr = lowrank_refresh(mask(grads, is_low), chain_state[0], mask(params, is_low))
        return state._replace(inner={**state.inner, "gum": (new_lr,) + chain_state[1:]})

    def project(grads: dict, state, params: dict) -> dict:
        is_low = labels(params)
        views = _per_leaf_state(_lowrank_state(state), params, is_low)
        out = {}
        for k, g in grads.items():
            if g is None:
                out[k] = None
                continue
            g32 = g.to(torch.float32)
            if k not in views:
                out[k] = {"raw": g32}
                continue
            proj, idx = views[k]
            fs = family_shape(params[k], rank)
            out[k] = {"low": dispatch.project(proj, g32, side=fs.side, impl=kernel_impl,
                                              pad_rank_to=pad_rank_to)}
            if idx is not None:
                out[k]["full"] = gather_blocks(g32, idx, fs)
        return out

    def reconstruct(compact: dict, state, params: dict) -> dict:
        is_low = labels(params)
        views = _per_leaf_state(_lowrank_state(state), params, is_low)
        out = {}
        for k, c in compact.items():
            if c is None or k not in views:
                out[k] = None if c is None else c["raw"]
                continue
            proj, idx = views[k]
            fs = family_shape(params[k], rank)
            g_hat = dispatch.back_project(proj, c["low"], side=fs.side, impl=kernel_impl,
                                          pad_rank_to=pad_rank_to)
            if "full" in c:
                g_hat = scatter_blocks(g_hat, idx, c["full"], fs)
            out[k] = g_hat
        return out

    return GUMAccumTools(transform=transform, refresh=refresh, project=project,
                         reconstruct=reconstruct, refresh_reads=refresh_reads)
