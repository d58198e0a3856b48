"""Composable optimizer combinators: the JAX package's
``core/combinators.py`` on PyTorch tensors.

atomic gradient transforms
    scale_by_momentum    EMA momentum (SGDM; Property-II compliant)
    scale_by_muon        momentum + Newton-Schulz orthogonalization
                         (optionally Nesterov and Muon's shape scale)
    scale_by_adam        bias-corrected Adam direction (GaLore's alpha as
                         ``scale``)
    add_decayed_weights  decoupled weight decay   u + wd * p
    scale_by_lr          -schedule(count) * u     (terminal step of a chain)
    scale_by_factor      constant multiplier
    clip_by_global_norm  global-norm clipping as a chain stage

wrapper transforms
    lowrank(inner, ...)          owns the projector state: periodic refresh
                                 (svd | subspace | rsvd | random | grass),
                                 project / back-project through the kernel
                                 dispatch layer, runs ``inner`` in the
                                 projected space
    layerwise_unbias(base, ...)  the paper's sampling debiasing (gamma
                                 full-rank slots, paper/finetune compensation)
    with_fira_residual(base)     Fira's out-of-subspace residual
    with_matrix_routing(m, f)    matrices -> ``m``, the rest -> ``f``

composition
    chain(*transforms)           sequential application, optax semantics

so GUM is ``chain(lowrank(layerwise_unbias(scale_by_muon())),
add_decayed_weights(wd), scale_by_lr(lr))`` and GaLore
``chain(lowrank(scale_by_adam(scale=alpha)), add_decayed_weights(wd),
scale_by_lr(lr))``, each routed beside AdamW.

Trees are flat ``{path: leaf}`` dicts in the reference's leaf order (see
:mod:`repro_torch.core.api`).  ``lowrank`` hands its inner transform
:class:`ProjGrad` leaves — lazy projected gradients carrying the projector,
the raw fp32 gradient and the family geometry — and at init
:class:`ProjInit` leaves; an inner transform returns projected-space tensors
(``lowrank`` back-projects them) or :class:`FullUpdate`-wrapped full-shape
tensors (returned as they are).  PyTorch runs eagerly, so the period
boundary is a Python ``bool`` and only the taken branch runs.

``lowrank(external_refresh=True)`` leaves the period boundary to its
``update.refresh(grads, state, params)`` hook (the projected-space gradient
accumulation refreshes against microbatch 0's raw gradient before it
projects); the inner transform's ``refresh_state`` hook resamples and
resets there.

``lowrank(fuse_families=True)`` groups same-signature leaves into stacked
``(L, m, n)`` super-leaves (:mod:`repro_torch.core.family_plan`) and runs the
whole pipeline — projector refresh, projection, inner transform,
back-projection — once per family; the inner transform sees one
:class:`ProjGrad` per family whose ``seg`` carries the member geometry, and
``layerwise_unbias`` samples per member with each member's own key, so the
stacked trajectory equals the per-leaf one.  ``fused_epilogue=True`` defers
the final back-projection into :class:`PendingBack` leaves: the chain tail
(``scale_by_factor``, ``add_decayed_weights``, ``scale_by_lr``) folds its
scalars into them and ``scale_by_lr`` materializes the tree through the
fused ``back_project_epilogue`` kernel, one launch per family.  Inners that
emit :class:`FullUpdate` leaves (``layerwise_unbias``) own their
back-projection, so the epilogue knob is inert for GUM.

``lowrank(rank=RankMap, rank_policy=..., probe_spectrum=...)``: the rank may
differ per ``(m, n)`` family (:mod:`repro_torch.core.rank_policy`), and with
probing on every refresh stores each leaf's (or family's) spectrum probe in
``LowRankState.probes`` for the rank-policy controller.
``lowrank(telemetry=True)`` adds to those probes the projector drift at
each refresh and a bias residual sampled each step, which
:mod:`repro_torch.telemetry.instrument` reads; the update never reads them.

Under :func:`family_sharding` (a data-parallel step whose ranks all hold the
whole reduced gradient) the family-stacked state is ZeRO-split: rank ``k``
of ``n`` keeps rows ``[k·L/n, (k+1)·L/n)`` of every family-stacked state
tensor whose leading dim divides (:func:`shard_family_state`; the rule of
:func:`repro_torch.sharding.family_state_sharding`), refreshes and updates
only those rows, and one all-gather a step, over every split family at once,
joins the update rows back to full size (see :func:`family_sharding`).  Fira's
per-block norm memory, which the rule keeps whole, rides in that gather as
this rank's rows; under ``fused_epilogue`` a split family's projector rows
and projected update rows ride there in place of its update rows, and every
rank runs the epilogue over the whole stack.  The external refresh (the
projected-space accumulator) is the one path refused under it.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.api import (
    PyTree,
    Schedule,
    Transform,
    multi_transform,
    schedule_value,
    tree_map,
    tree_paths,
)
from repro_torch.core.api import clip_by_global_norm as _clip_tree
from repro_torch.core.family_plan import (
    build_family_plan,
    member_keys,
    stack_family,
    unstack_family,
)
from repro_torch.core.lowrank_common import (
    BlockSel,
    FamilyShape,
    Noise,
    compute_projectors,
    default_lowrank_filter,
    family_shape,
    gather_blocks,
    lowrank_state_shape,
    proj_shape,
    project,
    scatter_blocks,
    stack_shardable,
)
from repro_torch.core.newton_schulz import muon_scale
from repro_torch.kernels import dispatch

# sampler(key, L, g_f) -> (g_f,) distinct block ids in [0, L); key is
# (seed, count, leaf index), the inputs the reference folds into its PRNG key.
# Under family stacking it is called once per member, with that member's key
# and block count.
Sampler = Callable[[tuple[int, int, int], int, int], torch.Tensor]


def generator_sampler(key: tuple[int, int, int], L: int, g_f: int) -> torch.Tensor:
    """Default block sampler: ``g_f`` of ``L`` blocks without replacement
    from a CPU ``torch.Generator`` seeded by the key — counter-based like the
    reference's ``fold_in`` chain, so a draw depends only on (seed, step,
    leaf).  Not the reference's threefry bits: parity tests inject those."""
    seed, count, leaf = key
    gen = torch.Generator().manual_seed((seed * 1_000_003 + count) * 1_000_003 + leaf)
    return torch.randperm(L, generator=gen)[:g_f]


# ---------------------------------------------------------------------------
# Leaf protocol objects
# ---------------------------------------------------------------------------


class TensorSpec(NamedTuple):
    """Shape and device of a state tensor still to be allocated."""

    shape: tuple[int, ...]
    device: torch.device


class ProjInit:
    """Init-time stand-in for a low-rank leaf inside :func:`lowrank`:
    ``low`` is the projected-space state's spec, ``fs`` the family geometry,
    ``seg`` the member geometry under family stacking (None per leaf)."""

    __slots__ = ("fs", "low", "seg")

    def __init__(self, fs: FamilyShape, low: TensorSpec, seg=None):
        self.fs = fs
        self.low = low
        self.seg = seg


class ProjGrad:
    """Lazy projected gradient leaf handed to transforms inside ``lowrank``."""

    __slots__ = ("p", "g", "fs", "kernel_impl", "pad_rank_to", "coeff", "reset",
                 "refresh", "key", "seg", "shard")

    def __init__(self, p, g, fs, kernel_impl, pad_rank_to=0, coeff=1.0, reset=False,
                 refresh=False, key=None, seg=None, shard=None):
        self.p = p                      # (*lead, s, r) refreshed projector
        self.g = g                      # (*lead, m, n) raw fp32 gradient
        self.fs = fs                    # FamilyShape
        self.kernel_impl = kernel_impl
        self.pad_rank_to = pad_rank_to  # the dispatcher's rank padding
        self.coeff = coeff              # float on the projected gradient
        self.reset = reset              # zero momenta first (period boundary)
        self.refresh = refresh          # period boundary: resample blocks
        self.key = key                  # (seed, count, leaf index); a list of
                                        # them, one per member, when stacked
        self.seg = seg                  # StackSeg when stacked (else None)
        self.shard = shard              # ShardView under family_sharding: p and g
                                        # are then this rank's rows of the stack

    def with_coeff(self, coeff: float) -> "ProjGrad":
        return ProjGrad(self.p, self.g, self.fs, self.kernel_impl, self.pad_rank_to,
                        coeff, self.reset, self.refresh, self.key, self.seg, self.shard)

    def apply_reset(self, x):
        return torch.zeros_like(x) if self.reset else x

    def materialize(self):
        """The projected gradient PᵀG / G P through the projection kernel
        (coeff NOT applied: elementwise consumers fold it in themselves)."""
        return dispatch.project(self.p, self.g, side=self.fs.side,
                                impl=self.kernel_impl, pad_rank_to=self.pad_rank_to)

    def fused_momentum(self, mu, beta: float):
        """``beta * mu + coeff * PᵀG`` through the fused momentum kernel."""
        return dispatch.lowrank_update(self.p, self.g, self.apply_reset(mu), beta,
                                       self.coeff, side=self.fs.side,
                                       impl=self.kernel_impl, pad_rank_to=self.pad_rank_to)

    def back(self, s):
        """Back-project a projected-space tensor to full shape."""
        return dispatch.back_project(self.p, s, side=self.fs.side,
                                     impl=self.kernel_impl, pad_rank_to=self.pad_rank_to)


class FullUpdate:
    """Marker for a leaf that is already in full (m, n) space."""

    __slots__ = ("u",)

    def __init__(self, u):
        self.u = u


class ShardView(NamedTuple):
    """One family stack on rank ``k`` of ``n`` under :func:`family_sharding`:
    the rows ``[a, b)`` its state holds (all ``L`` when the stack does not
    divide, ``split`` False), the whole stacked gradient every rank holds
    after the all-reduce, and at a refresh ``project_blocks(ids)``: the
    projectors of any blocks of the stack, computed as the whole stack's
    are (the same gradient, keys and draws)."""

    k: int
    n: int
    rows: tuple[int, int]
    split: bool
    g_full: torch.Tensor
    project_blocks: Optional[Callable] = None


class RowsUpdate:
    """An inner transform's update of one split family (under
    :func:`family_sharding`): ``rows`` of the update this rank computed
    (the rank's rows, or all of them when the stack does not divide), and
    the slots still to land after ``lowrank`` gathers the rows: ``slots``,
    this rank's share of them to gather too, or ``slot_vals``, every slot
    (computed alike on every rank), each scattered to its block of ``idx``.
    ``riders`` (a split family's only) are ``(rows, whole)`` pairs of the
    inner's new state: this rank's rows of a state tensor that the rule
    keeps whole on every rank (Fira's norm memory), which ride in the same
    all-gather and are written into ``whole`` in place."""

    __slots__ = ("rows", "slots", "idx", "slot_vals", "riders")

    def __init__(self, rows, slots=None, idx=None, slot_vals=None, riders=()):
        self.rows = rows
        self.slots = slots
        self.idx = idx
        self.slot_vals = slot_vals
        self.riders = tuple(riders)


class RefreshMsg:
    """Per-leaf message of the external-refresh hook (see :func:`lowrank`):
    the family geometry and the sampling key, a list of per-member keys and
    the member geometry under family stacking."""

    __slots__ = ("fs", "key", "seg")

    def __init__(self, fs: FamilyShape, key, seg=None):
        self.fs = fs
        self.key = key
        self.seg = seg


class PendingBack:
    """Lazy scale-and-back-project leaf (``fused_epilogue=True``):
    ``scale * back_project(p, s) + decay * W`` not yet computed.

    Tail transforms fold their scalars in (``scale_by_lr`` and
    ``scale_by_factor`` through :meth:`scaled`, ``add_decayed_weights``
    through :meth:`decayed`); ``scale_by_lr``, the terminal stage of every
    chain, then materializes the tree through
    :func:`repro_torch.kernels.dispatch.back_project_epilogue`, one launch per
    family stack (:func:`materialize_pending`).  Under family stacking every
    member leaf shares one ``(p, s, w)`` payload and ``member`` selects this
    leaf's slice; the grouped launch reads the scalars of the first member,
    so a chain tail must apply the same scalars to every leaf, as every
    built-in tail does.  ``w`` is the params tensor, or a thunk that stacks
    the family's params, called only when ``decay`` is non-zero."""

    __slots__ = ("p", "s", "w", "fs", "kernel_impl", "pad_rank_to", "scale", "decay",
                 "member", "members", "member_lead")

    def __init__(self, p, s, w, fs, kernel_impl, pad_rank_to=0, scale=1.0, decay=0.0,
                 member=None, members=1, member_lead=()):
        self.p = p                      # projector, possibly family-stacked
        self.s = s                      # projected-space update (group key)
        self.w = w                      # params (the decay term), or a thunk
        self.fs = fs
        self.kernel_impl = kernel_impl
        self.pad_rank_to = pad_rank_to
        self.scale = scale              # float
        self.decay = decay              # float
        self.member = member            # None = unstacked leaf
        self.members = members
        self.member_lead = member_lead

    def _replace(self, scale: float, decay: float) -> "PendingBack":
        return PendingBack(self.p, self.s, self.w, self.fs, self.kernel_impl,
                           self.pad_rank_to, scale, decay, self.member, self.members,
                           self.member_lead)

    def scaled(self, f: float) -> "PendingBack":
        return self._replace(f * self.scale, f * self.decay)

    def decayed(self, wd: float) -> "PendingBack":
        return self._replace(self.scale, self.decay + wd)

    def materialize_stack(self) -> torch.Tensor:
        """The whole (possibly stacked) update through the fused epilogue;
        the W operand is read only when ``decay`` is non-zero."""
        w = None
        if self.decay != 0.0:
            w = self.w() if callable(self.w) else self.w
        return dispatch.back_project_epilogue(
            self.p, self.s, w=w, scale=self.scale, decay=self.decay,
            side=self.fs.side, impl=self.kernel_impl, pad_rank_to=self.pad_rank_to)

    def materialize_update(self) -> torch.Tensor:
        """This leaf alone (the ungrouped path of ``apply_updates``)."""
        return _member_slice(self.materialize_stack(), self)


def _member_slice(stacked: torch.Tensor, leaf: PendingBack) -> torch.Tensor:
    """This leaf's ``(*member_lead, m, n)`` slice of a family-stacked array
    (the array itself for an unstacked leaf)."""
    if leaf.member is None:
        return stacked
    parts = stacked.reshape((leaf.members,) + leaf.member_lead
                            + tuple(stacked.shape[-2:]))
    return parts[leaf.member]


def materialize_pending(updates: dict) -> dict:
    """Materialize every :class:`PendingBack` leaf, one
    ``back_project_epilogue`` launch per family stack (members are grouped
    by the identity of their shared ``s``).  Other leaves pass as they are.
    Under :func:`param_parts` a split leaf's update is this rank's part: its
    group launches on the cut operands (:func:`_materialize_cut`), one
    launch for the members that split the same dims the same way."""
    groups: dict[tuple, list[str]] = {}
    for k, leaf in updates.items():
        if isinstance(leaf, PendingBack):
            groups.setdefault((id(leaf.s), _pending_cut(k, leaf)), []).append(k)
    if not groups:
        return updates
    out = dict(updates)
    for (_, cut), keys in groups.items():
        if cut is not None:
            out.update(_materialize_cut(updates, keys, cut))
            continue
        full = updates[keys[0]].materialize_stack()
        for k in keys:
            out[k] = _member_slice(full, updates[k])
    return out


def _pending_cut(path: str, leaf: PendingBack):
    """How :func:`param_parts` cuts the leaf at ``path``: ``"whole"`` where
    it splits none, else a tuple of ``(side, index, count)`` for each split
    matrix dim, ``side`` ``"row"`` or ``"col"`` (one of each where a leaf
    splits over two axes); None outside :func:`param_parts`."""
    part = _PARAM_PARTS.get(path)
    if part is None:
        return None
    rule = part[1]
    if rule is None:
        return "whole"
    ndim = len(leaf.member_lead if leaf.member is not None else leaf.fs.lead) + 2
    sides = {ndim - 2: "row", ndim - 1: "col"}
    if any(c.dim not in sides for c in rule.cuts):
        raise NotImplementedError(f"{path}: a fused epilogue over a split of a stack dim is "
                                  "not ported (only the update's row or column dim splits)")
    return tuple(sorted((sides[c.dim], c.index, c.count) for c in rule.cuts))


def _materialize_cut(updates: dict, keys: list[str], cut) -> dict:
    """This rank's part of each of ``keys``' updates, which share one
    :class:`PendingBack` payload and split the same matrix dims alike: one
    epilogue launch on P's rows (left side) or S's rows (right side) for a
    row split, on S's columns (left) or P's rows (right) for a column split
    (both for a leaf split over two axes), with W the stacked parts,
    ``scale·P_k S + decay·W_k``: the same function on smaller operands."""
    first = updates[keys[0]]
    p, s = first.p, first.s
    if first.member is not None:
        members = [updates[k].member for k in keys]
        if members != list(range(first.members)):  # the members of this cut only
            per = p.shape[0] // first.members
            sel = torch.cat([torch.arange(j * per, (j + 1) * per, device=p.device)
                             for j in members])
            p, s = p[sel], s[sel]
    from repro_torch.sharding import RowSplit

    def narrow(t: torch.Tensor, dim: int) -> torch.Tensor:
        a, b = rule.rows(int(t.shape[dim]))
        return t.narrow(dim, a, b - a).contiguous()

    left = first.fs.side == "left"
    for side, index, count in () if cut == "whole" else cut:
        rule = RowSplit(index, count)
        if side == "row":
            p, s = (narrow(p, -2), s) if left else (p, narrow(s, -2))
        else:
            p, s = (p, narrow(s, -1)) if left else (narrow(p, -2), s)
    w = None
    if first.decay != 0.0:
        parts = [_PARAM_PARTS[k][0] for k in keys]
        w = parts[0] if first.member is None else torch.stack(parts).reshape(
            (-1,) + tuple(parts[0].shape[-2:]))
    out = dispatch.back_project_epilogue(p, s, w=w, scale=first.scale, decay=first.decay,
                                         side=first.fs.side, impl=first.kernel_impl,
                                         pad_rank_to=first.pad_rank_to)
    if first.member is None:
        return {keys[0]: out}
    out = out.reshape((len(keys),) + tuple(first.member_lead) + tuple(out.shape[-2:]))
    return {k: out[i] for i, k in enumerate(keys)}


def _zeros_momentum(leaf):
    if leaf is None:
        return None
    if isinstance(leaf, ProjInit):
        leaf = leaf.low
    return torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)


def _reset_floats(tree: PyTree) -> PyTree:
    """Zeros in place of every float tensor (ints and Python counters pass)."""
    return tree_map(lambda x: torch.zeros_like(x)
                    if isinstance(x, torch.Tensor) and x.is_floating_point() else x,
                    tree)


def _momentum_init(params: dict) -> dict:
    return {k: _zeros_momentum(v) for k, v in params.items()}


# ---------------------------------------------------------------------------
# chain
# ---------------------------------------------------------------------------


def chain_info(t: Transform) -> dict:
    """Static composition metadata of a combinator-built transform.

    Every combinator of this module (and ``multi_transform`` and ``lisa``)
    tags its update function with a ``chain_info`` dict, ``{"kind":
    <combinator name>, ...}``, with the reference's keys, nesting through
    ``stages`` (chain), ``inner`` (lowrank / layerwise_unbias /
    with_fira_residual / lisa) and ``branches`` (multi_transform), so the
    static audit (:mod:`repro_torch.analysis`) walks the composition
    without running it.  Other transforms read as ``{"kind": "opaque"}``."""
    info = getattr(t.update, "chain_info", None) if t is not None else None
    return dict(info) if info else {"kind": "opaque"}


def chain(*transforms: Transform) -> Transform:
    """Sequentially compose gradient transforms; state is the tuple of inner
    states."""

    def init(params: PyTree) -> tuple:
        return tuple(t.init(_part_standins(params) if _on_parts(t) else params)
                     for t in transforms)

    def update(updates: PyTree, state: tuple, params: PyTree):
        new_states = []
        for t, s in zip(transforms, state):
            if _on_parts(t):
                updates = {k: cut_update(k, u) for k, u in updates.items()}
            updates, ns = t.update(updates, s, params)
            new_states.append(ns)
        return updates, tuple(new_states)

    # A chain that starts with a params-reading lowrank inner (e.g.
    # layerwise_unbias) reads them too.
    if transforms and getattr(transforms[0].update, "wants_params", False):
        update.wants_params = True
    update.chain_info = {"kind": "chain", "stages": [chain_info(t) for t in transforms]}
    return Transform(init, update)


# ---------------------------------------------------------------------------
# atomic transforms
# ---------------------------------------------------------------------------


def _shape_scale(g, p, use_muon_scale: bool) -> float:
    """Muon's sqrt(max(1, m/n)) for a leaf (1.0 when off): the family's
    (m, n) on a ProjGrad, else the param's (the gradient's) last two dims."""
    if not use_muon_scale:
        return 1.0
    if isinstance(g, ProjGrad):
        return muon_scale((g.fs.m, g.fs.n))
    return muon_scale(tuple((p if p is not None else g).shape))


def scale_by_momentum(beta: float = 0.9, use_muon_scale: bool = False) -> Transform:
    """EMA momentum direction ``mu' = beta mu + g`` (Property-II compliant).
    On :class:`ProjGrad` leaves the update runs through the fused low-rank
    momentum kernel.  ``use_muon_scale`` applies Muon's sqrt(max(1, m/n))
    factor (GUM's ``base="sgdm"`` variant)."""

    def update(updates: dict, mu: dict, params: dict):
        out, new_mu = {}, {}
        for k, g in updates.items():
            if g is None:
                out[k] = new_mu[k] = None
                continue
            if isinstance(g, ProjGrad):
                m2 = g.fused_momentum(mu[k], beta)
            else:
                m2 = beta * mu[k] + g.to(torch.float32)
            scale = _shape_scale(g, params.get(k), use_muon_scale)
            out[k] = scale * m2 if scale != 1.0 else m2
            new_mu[k] = m2
        return out, new_mu

    update.chain_info = {"kind": "scale_by_momentum", "beta": beta}
    return Transform(_momentum_init, update)


def scale_by_muon(beta: float = 0.95, ns_steps: int = 5, nesterov: bool = False,
                  use_muon_scale: bool = False, kernel_impl: str = "auto") -> Transform:
    """Momentum + Newton-Schulz orthogonalization (the Muon direction).
    Full-rank leaves get EMA momentum (with ``nesterov``, NS reads ``beta
    mu' + g``); ProjGrad leaves run the fused low-rank momentum kernel —
    under ``nesterov`` the projection kernel, since the projected gradient
    enters twice — then NS in the projected space (Property II: NS(P X) =
    P NS(X)).  ``use_muon_scale`` multiplies by sqrt(max(1, m/n))."""

    def update(updates: dict, mu: dict, params: dict):
        out, new_mu = {}, {}
        for k, g in updates.items():
            if g is None:
                out[k] = new_mu[k] = None
                continue
            if isinstance(g, ProjGrad):
                if nesterov:
                    r_g = g.materialize()
                    if g.coeff != 1.0:
                        r_g = g.coeff * r_g
                    m2 = beta * g.apply_reset(mu[k]) + r_g
                    mom = beta * m2 + r_g
                else:
                    m2 = mom = g.fused_momentum(mu[k], beta)
            else:
                g32 = g.to(torch.float32)
                m2 = beta * mu[k] + g32
                mom = beta * m2 + g32 if nesterov else m2
            o = dispatch.newton_schulz(mom, steps=ns_steps, impl=kernel_impl)
            scale = _shape_scale(g, params.get(k), use_muon_scale)
            out[k] = scale * o if scale != 1.0 else o
            new_mu[k] = m2
        return out, new_mu

    update.chain_info = {"kind": "scale_by_muon", "beta": beta, "ns_steps": ns_steps,
                         "nesterov": nesterov}
    return Transform(_momentum_init, update)


class ScaleByAdamState(NamedTuple):
    count: int
    mu: PyTree
    nu: PyTree


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  scale: float = 1.0) -> Transform:
    """Bias-corrected Adam direction, optionally pre-scaled (GaLore's alpha).

    Full-shape leaves (AdamW) take it elementwise; :class:`ProjGrad` leaves
    inside ``lowrank`` (GaLore) take it on the projected gradient from the
    projection kernel, times the leaf's coeff, with both moments zeroed at a
    period boundary under ``reset_on_refresh``."""

    def init(params: dict) -> ScaleByAdamState:
        return ScaleByAdamState(count=0, mu=_momentum_init(params),
                                nu=_momentum_init(params))

    def update(updates: dict, state: ScaleByAdamState, params: dict):
        count = state.count + 1
        # In fp32 as the reference does (a float exponent: an int one takes
        # another pow): 1 - b2**t cancels, so one ulp of b2**t moves bc2 by
        # ~3e-5 relative at small t.
        t = torch.tensor(float(count))
        bc1, bc2 = (float(1.0 - torch.tensor(b, dtype=torch.float32) ** t) for b in (b1, b2))
        out, mu, nu = {}, {}, {}
        for k, g in updates.items():
            m, v = state.mu[k], state.nu[k]
            if g is None:
                out[k] = mu[k] = nu[k] = None
                continue
            if isinstance(g, ProjGrad):
                g32 = g.materialize()
                if g.coeff != 1.0:
                    g32 = g.coeff * g32
                m, v = g.apply_reset(m), g.apply_reset(v)
            else:
                g32 = g.to(torch.float32)
            m2 = b1 * m + (1 - b1) * g32
            v2 = b2 * v + (1 - b2) * torch.square(g32)
            s = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
            out[k] = scale * s if scale != 1.0 else s
            mu[k], nu[k] = m2, v2
        return out, ScaleByAdamState(count=count, mu=mu, nu=nu)

    update.chain_info = {"kind": "scale_by_adam", "scale": scale}
    return Transform(init, update)


def add_decayed_weights(weight_decay: float = 0.0) -> Transform:
    """Decoupled weight decay ``u + wd * p`` (apply before scale_by_lr)."""

    def one(k, u, p):
        if u is None:
            return None
        if isinstance(u, PendingBack):
            return u.decayed(weight_decay)
        if k in _PARAM_PARTS:  # the live parameter: a split one's part
            p = _PARAM_PARTS[k][0]
        return u + weight_decay * p.to(torch.float32)

    def update(updates: dict, state, params: dict):
        if weight_decay == 0.0:
            return updates, ()
        return {k: one(k, u, params[k]) for k, u in updates.items()}, ()

    update.chain_info = {"kind": "add_decayed_weights", "weight_decay": weight_decay}
    return Transform(lambda params: (), update)


class ScaleByLrState(NamedTuple):
    count: int


def scale_by_lr(lr: Schedule) -> Transform:
    """Terminal step: ``-schedule(count) * u``; deferred epilogues
    (:class:`PendingBack`) materialize here, one fused launch per family."""

    def one(u, step: float):
        if u is None:
            return None
        if isinstance(u, PendingBack):
            return u.scaled(-step)
        return (-step) * u

    def update(updates: dict, state: ScaleByLrState, params: dict):
        count = state.count + 1
        step = schedule_value(lr, count)
        out = materialize_pending({k: one(u, step) for k, u in updates.items()})
        return out, ScaleByLrState(count=count)

    update.chain_info = {"kind": "scale_by_lr"}
    return Transform(lambda params: ScaleByLrState(count=0), update)


def scale_by_factor(factor: float) -> Transform:
    """Constant multiplier (an alpha applied outside the base).  Composes
    inside ``lowrank`` too: :class:`ProjGrad` leaves scale through their
    coeff, :class:`FullUpdate` and :class:`PendingBack` leaves through their
    payload."""

    def one(u):
        if u is None:
            return None
        if isinstance(u, ProjGrad):
            return u.with_coeff(factor * u.coeff)
        if isinstance(u, FullUpdate):
            return FullUpdate(factor * u.u)
        if isinstance(u, PendingBack):
            return u.scaled(factor)
        return factor * u

    def update(updates: dict, state, params: dict):
        return {k: one(u) for k, u in updates.items()}, ()

    update.chain_info = {"kind": "scale_by_factor", "factor": factor}
    return Transform(lambda params: (), update)


def clip_by_global_norm(max_norm: float) -> Transform:
    """Global-norm clipping as a chain stage (the transform twin of
    :func:`repro_torch.core.api.clip_by_global_norm`); deferred epilogues
    materialize first, since the norm reads every leaf."""

    def update(updates: dict, state, params: dict):
        if _PARAM_PARTS:
            raise NotImplementedError("clip_by_global_norm as a chain stage under split "
                                      "parameters (shard_params) is not ported: its norm "
                                      "would read parts; clip in the step (grad_clip)")
        return _clip_tree(materialize_pending(updates), max_norm), ()

    update.chain_info = {"kind": "clip_by_global_norm"}
    return Transform(lambda params: (), update)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def with_matrix_routing(
    matrix: Transform,
    fallback: Transform,
    *,
    matrix_filter: Callable[[str, torch.Tensor], bool] = default_lowrank_filter,
    matrix_label: str = "matrix",
    fallback_label: str = "adamw",
) -> Transform:
    """Route hidden-matrix leaves to ``matrix`` and everything else
    (embeddings / norms / biases) to ``fallback``."""

    def label_fn(params: dict) -> dict:
        return {k: matrix_label if matrix_filter(path, params[k]) else fallback_label
                for k, path in tree_paths(params).items()}

    return multi_transform({matrix_label: matrix, fallback_label: fallback}, label_fn)


# ---------------------------------------------------------------------------
# Split parameters (shard_params): the update of a rank's parts
# ---------------------------------------------------------------------------

# {path: (tensor, RowSplit / GridSplit or None)} of the active param_parts declaration ({} without
# one); the optimizer runs on the calling thread.
_PARAM_PARTS: dict = {}


@contextlib.contextmanager
def param_parts(parts: dict):
    """Declare that the parameters are split (``shard_params``): ``parts``
    maps each leaf's path to ``(tensor, rule)``, this rank's part and its
    :class:`repro_torch.sharding.RowSplit` (or ``GridSplit``: a leaf split
    over the data and the model axis), or a whole leaf and None.

    Entered by the mesh step around ``optimizer.init`` and
    ``optimizer.update``, which then take whole-shaped stand-ins for the
    parameters (their shapes are what every stage but the decay reads) and
    whole gradients.  The cut has one seam, :func:`chain`: before each
    stage of :data:`_PART_STAGES` (the elementwise ones) it cuts every
    whole update of a split leaf to the rank's part, and it inits those
    stages on stand-ins of the parts' shapes, so ``scale_by_adam`` and
    ``scale_by_momentum`` keep state of the part's shape (AdamW's moments
    split as the reference's ``opt_state_sharding`` splits them) and
    ``add_decayed_weights`` and ``scale_by_lr`` see parts.  Two stages read
    the declaration themselves: ``add_decayed_weights`` the live part it
    decays, and a :class:`PendingBack` launches on its cut operands with
    W's part (:func:`materialize_pending`).  The low-rank stages and Muon
    run on whole gradients with whole state, as unsplit."""
    global _PARAM_PARTS
    prev, _PARAM_PARTS = _PARAM_PARTS, dict(parts)
    try:
        yield
    finally:
        _PARAM_PARTS = prev


# The stages that run on a split leaf's part (cut in front of them by chain).
_PART_STAGES = frozenset({"scale_by_adam", "scale_by_momentum", "add_decayed_weights",
                          "scale_by_lr"})


def _on_parts(t: Transform) -> bool:
    """Whether :func:`chain` hands ``t`` this rank's parts: under
    :func:`param_parts`, a stage of :data:`_PART_STAGES`."""
    return bool(_PARAM_PARTS) and chain_info(t)["kind"] in _PART_STAGES


def _part_standins(params: dict) -> dict:
    """``params`` with each split tensor leaf a zero-stride stand-in of its
    part's shape (what an elementwise stage's init reads)."""
    out = dict(params)
    for k, v in params.items():
        rule = _PARAM_PARTS[k][1] if k in _PARAM_PARTS else None
        if isinstance(v, torch.Tensor) and rule is not None:
            out[k] = v.new_zeros(()).expand(rule.part_shape(v.shape))
    return out


def cut_update(path: str, u):
    """This rank's part of a whole update ``u`` of the leaf at ``path``
    under :func:`param_parts` (``u`` itself where the leaf is whole or ``u``
    is a part already)."""
    part = _PARAM_PARTS.get(path)
    if part is None or part[1] is None or u is None or isinstance(u, PendingBack):
        return u
    if tuple(u.shape) == tuple(part[0].shape):
        return u
    return part[1].narrow(u)


# ---------------------------------------------------------------------------
# ZeRO-style family-state sharding context
# ---------------------------------------------------------------------------

_FAMILY_SHARDING = threading.local()


@contextlib.contextmanager
def family_sharding(mesh):
    """Declare that family-stacked low-rank state is split over ``mesh``'s
    data axis (``mesh.data_axis``) along the stack dim (the layout of
    :func:`shard_family_state`).

    Entered by the step builders (``launch.shardmap_fsdp`` and the mesh
    ``Trainer``) around ``optimizer.update``; the fused ``lowrank`` path
    reads it through :func:`active_family_sharding`.  Every rank holds the
    whole reduced gradient, so a refresh gathers nothing: each rank computes
    only its rows' projectors, with the whole stack's keys.  The update rows
    come back to full size in one all-gather a step, coalesced over the
    split families."""
    prev = getattr(_FAMILY_SHARDING, "mesh", None)
    _FAMILY_SHARDING.mesh = mesh
    try:
        yield
    finally:
        _FAMILY_SHARDING.mesh = prev


# The one refusal left under family_sharding: the projected-space
# accumulator (the external refresh) projects each rank's gradient onto every
# block's projector, and a split state holds only its rows' projectors.
ACCUM_SHARDING_REFUSAL = (
    "the projected-space accumulator (lowrank's external refresh) under shard_state "
    "(family_sharding) is not ported (ROADMAP queue 1 item 5i): each rank projects its "
    "own gradient onto every block's projector, and the split state holds only its "
    "rows' projectors; it needs a reduce-scatter of the raw gradients or a gather of "
    "the projectors")


def active_family_sharding():
    """The mesh of the active family-sharding declaration, or None."""
    return getattr(_FAMILY_SHARDING, "mesh", None)


def family_shard_count(mesh) -> int:
    """The shard count of ``mesh``'s data axis (1 when mesh is None)."""
    if mesh is None:
        return 1
    return int(mesh.shape[mesh.data_axis])


def _split_rows(L: int, k: int, n: int) -> tuple[tuple[int, int], bool]:
    """Rank ``k``'s rows of an ``(L, ...)`` stack and whether it splits."""
    if n > 1 and stack_shardable(L, n):
        per = L // n
        return (k * per, (k + 1) * per), True
    return (0, L), False


# ---------------------------------------------------------------------------
# lowrank — the projection wrapper
# ---------------------------------------------------------------------------


class LowRankState(NamedTuple):
    count: int
    projs: dict     # per-leaf projector (*lead, s, r) (None elsewhere); under
                    # family stacking {family index: (L, s, r)}
    inner: PyTree   # the wrapped transform's state (projected space)
    # Spectrum probes (``probe_spectrum=True``; None otherwise, which is no
    # checkpoint leaf): per leaf (keyed as ``projs``) a dict {"g2": () total
    # ||G||_F², "mn": (2,) int32 family shape, "sv2": (r,) squared singular
    # values of PᵀG summed over blocks}, made at each refresh — in the
    # reference's sorted key order, so checkpoint paths match its layout.
    probes: PyTree = None


def _eigen_sum(p, g32, fs: FamilyShape, kernel_impl: str, pad_rank_to: int) -> torch.Tensor:
    """The eigenvalues of each block's r x r Gram of ``PᵀG``, clamped at 0
    and summed over the blocks, in eigvalsh's ascending order.  ``PᵀG``
    goes through the projection kernel (``dispatch.project``, counted); the
    Gram is a plain product."""
    s = dispatch.project(p, g32, side=fs.side, impl=kernel_impl, pad_rank_to=pad_rank_to)
    gram = torch.matmul(s, s.mT) if fs.side == "left" else torch.matmul(s.mT, s)
    ev = torch.linalg.eigvalsh(gram).clamp_min(0.0)          # (*lead, r)
    return ev.reshape(-1, ev.shape[-1]).sum(0)


def _spectrum_probe(p, g32, fs: FamilyShape, kernel_impl: str, pad_rank_to: int) -> dict:
    """Squared singular values of the projected gradient sketch ``PᵀG``
    (:func:`_eigen_sum` in descending order) and the total gradient
    energy."""
    sv2 = torch.sort(_eigen_sum(p, g32, fs, kernel_impl, pad_rank_to), descending=True).values
    return {"g2": torch.sum(torch.square(g32)),
            "mn": torch.tensor((fs.m, fs.n), dtype=torch.int32, device=g32.device),
            "sv2": sv2}


def _probe_zeros(fs: FamilyShape, device: torch.device, telemetry: bool = False) -> dict:
    pr = {"g2": torch.zeros((), dtype=torch.float32, device=device),
          "mn": torch.tensor((fs.m, fs.n), dtype=torch.int32, device=device),
          "sv2": torch.zeros((fs.rank,), dtype=torch.float32, device=device)}
    if telemetry:
        pr["bias"] = torch.zeros((), dtype=torch.float32, device=device)
        pr["bias_step"] = torch.zeros((), dtype=torch.int32, device=device)
        pr["drift"] = torch.zeros((), dtype=torch.float32, device=device)
    return dict(sorted(pr.items()))


def _overlap_sum(p_old: torch.Tensor, p_new: torch.Tensor) -> torch.Tensor:
    """The summed squares of the r×r cross-Grams ``P_oldᵀ P_new`` over the
    blocks (a plain product, not dispatched and not counted)."""
    gram = torch.matmul(p_old.to(torch.float32).mT, p_new.to(torch.float32))
    return torch.sum(torch.square(gram))


def _drift_from(overlap_sum: torch.Tensor, r: int, blocks: int) -> torch.Tensor:
    return torch.clamp(1.0 - overlap_sum / (r * blocks), 0.0, 1.0)


def _subspace_drift(p_old: torch.Tensor, p_new: torch.Tensor) -> torch.Tensor:
    """How far the refreshed subspace moved: ``1 − mean squared overlap``
    of the two orthonormal projector stacks through the r×r cross-Gram
    ``P_oldᵀ P_new`` (0 = the same span, 1 = orthogonal), clipped to
    [0, 1].  The first refresh compares against the zero-initialised
    projector and reads 1."""
    return _drift_from(_overlap_sum(p_old, p_new), p_new.shape[-1],
                       math.prod(p_new.shape[:-2]))


def _captured_sum(p: torch.Tensor, g32: torch.Tensor, side: str) -> torch.Tensor:
    """``‖PᵀG‖²`` summed over the blocks (a plain product, not dispatched
    and not counted)."""
    return torch.sum(torch.square(project(p, g32, side)))


def _bias_from(captured: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - captured / torch.clamp_min(g2, 1e-30), 0.0, 1.0)


def _bias_residual(p: torch.Tensor, g32: torch.Tensor, side: str) -> torch.Tensor:
    """The fraction of this step's gradient energy outside the current
    subspace, ``1 − ‖PᵀG‖²/‖G‖²``, clipped to [0, 1]."""
    captured = _captured_sum(p, g32, side)
    return _bias_from(captured, torch.sum(torch.square(g32)))


def lowrank(
    inner: Transform,
    *,
    rank=128,
    period: int = 200,
    projector: str = "svd",
    seed: int = 0,
    subspace_iters: int = 2,
    reset_on_refresh: bool = False,
    external_refresh: bool = False,
    kernel_impl: str = "auto",
    pad_rank_to: int = 0,
    fuse_families: bool = False,
    fused_epilogue: bool = False,
    noise: Optional[Noise] = None,
    rank_policy=None,
    probe_spectrum: bool = False,
    telemetry: bool = False,
) -> Transform:
    """Run ``inner`` inside a periodically refreshed low-rank subspace.

    Every ``period`` steps (at ``(count - 1) % period == 0``) each leaf's
    projector is recomputed from its gradient by
    :func:`~repro_torch.core.lowrank_common.compute_projectors` (``projector``
    any of svd | subspace | rsvd | random | grass; ``subspace_iters`` power
    steps for subspace); with ``reset_on_refresh`` the inner momenta are
    zeroed at that boundary.  The key ``(seed, count, i)`` of leaf ``i`` —
    its position in the full parameter tree, as in the reference — is handed
    to the inner transform (its block sampler) and to ``noise``, the
    projector's random draws (default
    :func:`~repro_torch.core.lowrank_common.generator_noise`); family stacks
    draw per member with each member's key.

    ``external_refresh=True`` skips the in-update refresh: the caller runs
    the attached ``update.refresh(grads, state, params)`` hook on the step
    (before ``update``), which recomputes the projectors on a period
    boundary, has the inner transform resample and reset (its
    ``refresh_state`` hook; without one, ``reset_on_refresh`` zeroes its
    floats) and leaves ``count`` to ``update``.  Keys are the in-update
    path's, so the trajectory is the same either way.

    ``pad_rank_to`` is the dispatcher's rank padding (see
    :func:`repro_torch.kernels.dispatch._rank_granule`).
    ``fuse_families=True`` runs the pipeline once per family stack (see the
    module docstring); the inner state is then keyed by family index.
    ``fused_epilogue=True`` returns :class:`PendingBack` leaves in place of
    back-projected ones, for the chain tail to fold into one fused launch.

    ``rank`` is an int or a per-shape
    :class:`~repro_torch.core.rank_policy.RankMap`; ``rank_policy`` (a
    :class:`~repro_torch.core.rank_policy.RankPolicy`) supplies the initial
    map for an int rank and turns ``probe_spectrum`` on when it
    ``wants_probes``.  With ``probe_spectrum`` every refresh stores each
    leaf's (family's) spectrum probe in ``LowRankState.probes`` — the
    in-update refresh, or under ``external_refresh`` the refresh hook.

    ``telemetry=True`` (implies ``probe_spectrum``) also stores, in the same
    probe dicts, the projector drift since the previous refresh (at each
    refresh, the hook's too) and a bias residual measured each step on one
    leaf (family) picked round-robin, ``(count - 1) % sites``, with the step
    it was taken at (the in-update path only).  The update never reads
    these fields, so the parameter trajectory is bitwise that of
    ``telemetry=False``; their products are plain PyTorch, not dispatched
    and not counted."""
    if telemetry:
        probe_spectrum = True
    if rank_policy is not None:
        probe_spectrum = probe_spectrum or bool(getattr(rank_policy, "wants_probes", False))
        if isinstance(rank, int):
            rank = rank_policy.initial_map(rank)
    wants_params = bool(getattr(inner.update, "wants_params", False))
    inner_refresh_state = getattr(inner.update, "refresh_state", None)
    in_update_refresh = not external_refresh

    def _refresh_inner(state: LowRankState, msgs: dict):
        if inner_refresh_state is not None:
            return inner_refresh_state(state.inner, msgs)
        return _reset_floats(state.inner) if reset_on_refresh else state.inner

    def _msg(proj, g32, fs, refresh: bool, key, seg=None, shard=None) -> ProjGrad:
        refresh = refresh and in_update_refresh
        return ProjGrad(p=proj, g=g32, fs=fs, kernel_impl=kernel_impl,
                        pad_rank_to=pad_rank_to, reset=refresh and reset_on_refresh,
                        refresh=refresh, key=key, seg=seg, shard=shard)

    def _pending(p, o, w, fs: FamilyShape, **member) -> PendingBack:
        return PendingBack(p=p, s=o, w=w, fs=fs, kernel_impl=kernel_impl,
                           pad_rank_to=pad_rank_to, **member)

    def _probe_fresh(p_new, p_old, g32, fs: FamilyShape, old: dict) -> dict:
        """A refresh's probe: the spectrum sketch, plus (telemetry) the
        drift against the outgoing projector and the carried bias fields."""
        pr = _spectrum_probe(p_new, g32, fs, kernel_impl, pad_rank_to)
        if telemetry:
            pr |= {"bias": old["bias"], "bias_step": old["bias_step"],
                   "drift": _subspace_drift(p_old, p_new)}
        return dict(sorted(pr.items()))

    def _sample_bias(count: int, sites: list, probes: dict) -> None:
        """Round-robin bias sampling: ``sites`` lists (probe key, projector,
        gradient, side); the site of ``(count - 1) % len(sites)`` has its
        residual measured and written into a new probe dict of ``probes``."""
        if not sites:
            return
        k, p, g32, side = sites[(count - 1) % len(sites)]
        # torch.full, not torch.tensor: a fill launches with the step, where a
        # host-to-device copy would wait for the queued work of the step
        probes[k] = probes[k] | {
            "bias": _bias_residual(p, g32, side),
            "bias_step": torch.full((), count, dtype=torch.int32, device=g32.device)}

    def init(params: dict) -> LowRankState:
        projs, tmpls = {}, {}
        for k, p in params.items():
            if p is None:
                projs[k] = tmpls[k] = None
                continue
            fs = family_shape(p, rank)
            projs[k] = torch.zeros(proj_shape(fs), dtype=torch.float32, device=p.device)
            tmpls[k] = ProjInit(fs, TensorSpec(lowrank_state_shape(fs), p.device))
        probes = None
        if probe_spectrum:
            probes = {k: None if p is None
                      else _probe_zeros(family_shape(p, rank), p.device, telemetry)
                      for k, p in params.items()}
        return LowRankState(count=0, projs=projs, inner=inner.init(tmpls), probes=probes)

    def update(updates: dict, state: LowRankState, params: dict):
        count = state.count + 1
        refresh = (count - 1) % period == 0
        msgs, new_projs, sites = {}, {}, []
        new_probes = dict(state.probes) if probe_spectrum else None
        for i, (k, p) in enumerate(params.items()):
            g, proj = updates[k], state.projs[k]
            if g is None or p is None:
                msgs[k], new_projs[k] = None, proj
                continue
            fs = family_shape(p, rank)
            g32 = g.to(torch.float32)
            key = (seed, count, i)
            if refresh and in_update_refresh:
                proj = compute_projectors(projector, g32, fs.rank, fs.side, key=key,
                                          subspace_iters=subspace_iters, noise=noise)
                if probe_spectrum:
                    new_probes[k] = _probe_fresh(proj, state.projs[k], g32, fs,
                                                 state.probes[k])
            if telemetry and in_update_refresh:
                sites.append((k, proj, g32, fs.side))
            msgs[k] = _msg(proj, g32, fs, refresh, key)
            new_projs[k] = proj
        _sample_bias(count, sites, new_probes)

        inner_out, new_inner = inner.update(msgs, state.inner, params)

        out = {}
        for k, msg in msgs.items():
            o = inner_out[k]
            if msg is None or o is None:
                out[k] = None
            elif isinstance(o, FullUpdate):
                out[k] = o.u
            elif fused_epilogue:
                out[k] = _pending(msg.p, o, params[k], msg.fs)
            else:
                out[k] = msg.back(o)
        return out, LowRankState(count=count, projs=new_projs, inner=new_inner,
                                 probes=new_probes)

    def refresh(grads: dict, state: LowRankState, params: dict) -> LowRankState:
        count = state.count + 1
        if (count - 1) % period:
            return state
        msgs, new_projs = {}, {}
        new_probes = dict(state.probes) if probe_spectrum else None
        for i, (k, p) in enumerate(params.items()):
            g, proj = grads[k], state.projs[k]
            if g is None or p is None or proj is None:
                msgs[k], new_projs[k] = None, proj
                continue
            fs = family_shape(p, rank)
            key = (seed, count, i)
            g32 = g.to(torch.float32)
            new_projs[k] = compute_projectors(projector, g32, fs.rank, fs.side, key=key,
                                              subspace_iters=subspace_iters, noise=noise)
            if probe_spectrum:
                new_probes[k] = _probe_fresh(new_projs[k], proj, g32, fs, state.probes[k])
            msgs[k] = RefreshMsg(fs=fs, key=key)
        return LowRankState(count=state.count, projs=new_projs,
                            inner=_refresh_inner(state, msgs), probes=new_probes)

    def _plan(params: dict, grads: Optional[dict] = None):
        paths, leaves = list(params), list(params.values())
        plan = build_family_plan(leaves, rank)
        if grads is not None:
            for fam in plan.families:
                for i in fam.members:
                    if grads[paths[i]] is None:
                        raise ValueError(
                            "fuse_families=True requires gradient leaves to mask "
                            f"together with param leaves ({paths[i]} has no gradient)")
        return paths, leaves, plan

    def _stacked_grads(paths, updates) -> list:
        return [None if updates[k] is None else updates[k].to(torch.float32)
                for k in paths]

    def init_fused(params: dict) -> LowRankState:
        paths, _, plan = _plan(params)
        projs, tmpls = {}, {}
        for fi, fam in enumerate(plan.families):
            device = params[paths[fam.members[0]]].device
            projs[fi] = torch.zeros(proj_shape(fam.fs), dtype=torch.float32,
                                    device=device)
            tmpls[fi] = ProjInit(fam.fs, TensorSpec(lowrank_state_shape(fam.fs), device),
                                 seg=fam.seg)
        probes = None
        if probe_spectrum:
            probes = {fi: _probe_zeros(fam.fs, projs[fi].device, telemetry)
                      for fi, fam in enumerate(plan.families)}
        return LowRankState(count=0, projs=projs, inner=inner.init(tmpls), probes=probes)

    def _probe_partial(p_new, p_old, g_loc, g32, fs: FamilyShape, old: dict):
        """A split family's refresh probe: ``g2`` from the whole gradient,
        and the sums over this rank's blocks that the probe all-reduce adds
        up — the eigenvalue sums and (telemetry) the drift's overlap."""
        pr = {"g2": torch.sum(torch.square(g32)),
              "mn": torch.tensor((fs.m, fs.n), dtype=torch.int32, device=g32.device)}
        parts = [_eigen_sum(p_new, g_loc, fs, kernel_impl, pad_rank_to)]
        if telemetry:
            pr |= {"bias": old["bias"], "bias_step": old["bias_step"]}
            parts.append(_overlap_sum(p_old, p_new).reshape(1))
        return pr, parts

    def _finish_probes(new_probes: dict, partials: dict, plan, mesh) -> None:
        """One all-reduce of every split family's probe sums, then each
        probe from the totals."""
        flat = torch.cat([t for fi in partials for t in partials[fi]])
        mesh.all_reduce(flat, "probes")
        at = 0
        for fi, parts in partials.items():
            fs, pr = plan.families[fi].fs, new_probes[fi]
            sizes = [t.numel() for t in parts]
            tot = flat[at:at + sum(sizes)].split(sizes)
            at += sum(sizes)
            pr["sv2"] = torch.sort(tot[0], descending=True).values
            if telemetry:
                pr["drift"] = _drift_from(tot[1][0], fs.rank, fs.L)
            new_probes[fi] = dict(sorted(pr.items()))

    def update_fused(updates: dict, state: LowRankState, params: dict):
        """The pipeline once per family stack.  Under :func:`family_sharding`
        (the state in the layout of :func:`shard_family_state`) a family
        whose stack divides the axis refreshes its projectors and runs
        ``inner`` on this rank's rows; its update rows, the slots an inner
        could not place on them, the rows of an inner's whole-kept state
        (``RowsUpdate.riders``) and, under ``telemetry``, a split bias
        site's sum over this rank's blocks come back in one all-gather over
        all such families.  Under ``fused_epilogue`` a split family's
        projector rows and projected update rows ride in that gather in
        place of its update rows (``r·(m + n)`` values a block instead of
        ``m·n``), and every rank builds the whole stack's
        :class:`PendingBack`, so the chain tail folds into one epilogue
        launch over the whole stack, as unsharded.  Probe sums over blocks
        meet in one all-reduce at a refresh.  With one shard every family
        is whole and nothing is gathered."""
        mesh = active_family_sharding()
        n = family_shard_count(mesh)
        if n > 1 and not in_update_refresh:
            raise NotImplementedError(ACCUM_SHARDING_REFUSAL)
        k = mesh.coordinate(mesh.data_axis) if n > 1 else 0
        count = state.count + 1
        refresh = (count - 1) % period == 0
        paths, leaves, plan = _plan(params, updates)
        g_leaves = _stacked_grads(paths, updates)
        msgs, new_projs, fam_params, partials = {}, {}, {}, {}
        new_probes = dict(state.probes) if probe_spectrum else None
        kw = {"subspace_iters": subspace_iters, "noise": noise}
        for fi, fam in enumerate(plan.families):
            g32 = stack_family(fam, g_leaves)
            (a, b), split = _split_rows(fam.fs.L, k, n)
            g_loc = g32[a:b] if split else g32
            proj, keys = state.projs[fi], member_keys(fam, seed, count)
            project_blocks = None
            if refresh and in_update_refresh:
                sel = BlockSel(tuple(range(a, b)), fam.seg.member_L) if split else None
                proj = compute_projectors(projector, g_loc, fam.fs.rank, fam.fs.side,
                                          key=keys, blocks=sel, **kw)
                if probe_spectrum and split:
                    new_probes[fi], partials[fi] = _probe_partial(
                        proj, state.projs[fi], g_loc, g32, fam.fs, state.probes[fi])
                elif probe_spectrum:
                    new_probes[fi] = _probe_fresh(proj, state.projs[fi], g32, fam.fs,
                                                  state.probes[fi])

                def project_blocks(ids, fam=fam, g32=g32, keys=keys):
                    return compute_projectors(
                        projector, g32[list(ids)], fam.fs.rank, fam.fs.side, key=keys,
                        blocks=BlockSel(tuple(ids), fam.seg.member_L), **kw)

            shard = ShardView(k, n, (a, b), split, g32, project_blocks) if n > 1 else None
            msgs[fi] = _msg(proj, g_loc, fam.fs, refresh, keys, fam.seg, shard)
            new_projs[fi] = proj
            # Stacking the params costs a copy per family per step: only
            # for an inner that reads them (layerwise_unbias).
            fam_params[fi] = stack_family(fam, leaves) if wants_params else None
        bias_part = None
        if telemetry and in_update_refresh and msgs:
            fi = (count - 1) % len(msgs)
            m = msgs[fi]
            if m.shard is not None and m.shard.split:
                bias_part = (fi, _captured_sum(m.p, m.g, m.fs.side).reshape(1))
            else:
                _sample_bias(count, [(fi, m.p, m.g, m.fs.side)], new_probes)
        if partials:
            _finish_probes(new_probes, partials, plan, mesh)

        inner_out, new_inner = inner.update(msgs, state.inner, fam_params)

        def epilogue_parts(fi: int, p, s) -> list:
            fam = plan.families[fi]
            w = fam_params[fi]
            if w is None:  # stacked only if the decay term needs it
                w = lambda fam=fam: stack_family(fam, leaves)
            return [_pending(p, s, w, fam.fs, member=j, members=fam.seg.members,
                             member_lead=fam.member_fs.lead)
                    for j in range(fam.seg.members)]

        parts, pending, payload = {}, [], []
        for fi, fam in enumerate(plan.families):
            o, msg = inner_out[fi], msgs[fi]
            split = msg.shard is not None and msg.shard.split
            if isinstance(o, FullUpdate):
                parts[fi] = unstack_family(fam, o.u)
                continue
            if fused_epilogue and not isinstance(o, RowsUpdate):
                if split:  # the projector and projected update rows travel
                    pending.append((fi, o))
                    payload += [msg.p, o]
                else:
                    parts[fi] = epilogue_parts(fi, msg.p, o)
                continue
            if not isinstance(o, RowsUpdate):
                o = RowsUpdate(msg.back(o))
            if msg.shard is None or (not split and o.slots is None):
                u = o.rows if o.idx is None else o.rows.index_copy(0, o.idx, o.slot_vals)
                parts[fi] = unstack_family(fam, u)
                continue
            pending.append((fi, o))
            payload += [t for t in (o.rows if split else None, o.slots) if t is not None]
            payload += [rows for rows, _ in o.riders]
        if bias_part is not None:
            payload.append(bias_part[1])
        if payload:
            gathered = mesh.all_gather(torch.cat([t.reshape(-1) for t in payload]), "update")
            gathered = gathered.view(n, -1)
            at = 0

            def take(t: torch.Tensor) -> torch.Tensor:
                nonlocal at
                z = t.numel()
                part = gathered[:, at:at + z].reshape((n * t.shape[0],) + tuple(t.shape[1:]))
                at += z
                return part

            for fi, o in pending:
                if not isinstance(o, RowsUpdate):  # a split family's epilogue
                    parts[fi] = epilogue_parts(fi, take(msgs[fi].p), take(o))
                    continue
                u = take(o.rows) if msgs[fi].shard.split else o.rows
                if o.idx is not None:
                    vals = take(o.slots) if o.slots is not None else o.slot_vals
                    u = u.index_copy(0, o.idx, vals)
                for rows, whole in o.riders:
                    whole.copy_(take(rows))
                parts[fi] = unstack_family(plan.families[fi], u)
            if bias_part is not None:
                fi, g_full = bias_part[0], msgs[bias_part[0]].shard.g_full
                new_probes[fi] = new_probes[fi] | {
                    "bias": _bias_from(take(bias_part[1]).sum(),
                                       torch.sum(torch.square(g_full))),
                    "bias_step": torch.full((), count, dtype=torch.int32,
                                            device=g_full.device)}
        out = dict.fromkeys(paths)
        for fi, fam in enumerate(plan.families):
            for i, part in zip(fam.members, parts[fi]):
                out[paths[i]] = part
        return out, LowRankState(count=count, projs=new_projs, inner=new_inner,
                                 probes=new_probes)

    def refresh_fused(grads: dict, state: LowRankState, params: dict) -> LowRankState:
        if family_shard_count(active_family_sharding()) > 1:
            raise NotImplementedError(ACCUM_SHARDING_REFUSAL)
        count = state.count + 1
        if (count - 1) % period:
            return state
        paths, _, plan = _plan(params, grads)
        g_leaves = _stacked_grads(paths, grads)
        msgs, new_projs = {}, {}
        new_probes = dict(state.probes) if probe_spectrum else None
        for fi, fam in enumerate(plan.families):
            keys = member_keys(fam, seed, count)
            g32 = stack_family(fam, g_leaves)
            new_projs[fi] = compute_projectors(projector, g32, fam.fs.rank, fam.fs.side,
                                               key=keys, subspace_iters=subspace_iters,
                                               noise=noise)
            if probe_spectrum:
                new_probes[fi] = _probe_fresh(new_projs[fi], state.projs[fi], g32, fam.fs,
                                              state.probes[fi])
            msgs[fi] = RefreshMsg(fs=fam.fs, key=keys, seg=fam.seg)
        return LowRankState(count=state.count, projs=new_projs,
                            inner=_refresh_inner(state, msgs), probes=new_probes)

    info = {
        "kind": "lowrank", "inner": chain_info(inner), "rank": rank,
        "period": period, "projector": projector,
        "kernel_impl": kernel_impl, "pad_rank_to": pad_rank_to,
        "fuse_families": fuse_families, "fused_epilogue": fused_epilogue,
        "external_refresh": external_refresh, "rank_policy": rank_policy,
        "probe_spectrum": probe_spectrum, "telemetry": telemetry,
    }
    if fuse_families:
        update_fused.refresh = refresh_fused
        update_fused.chain_info = info
        return Transform(init_fused, update_fused)
    update.refresh = refresh
    update.chain_info = info
    return Transform(init, update)


# ---------------------------------------------------------------------------
# layerwise_unbias — the paper's debiasing, as a combinator
# ---------------------------------------------------------------------------


class LayerwiseUnbiasState(NamedTuple):
    low: PyTree    # base state over the projected-space leaves
    full: PyTree   # base state over the (gamma, m, n) full-rank slots
    idx: dict      # per-leaf (gamma,) slot -> block assignment
    # Under family_sharding only (None otherwise, which is no checkpoint
    # leaf): per family, the projectors of the blocks of the slots this rank
    # computes, (slots, s, r), where the family's projector rows are split
    # (a slot's block may lie in another rank's rows); None elsewhere.
    proj: PyTree = None


def layerwise_unbias(
    base: Transform,
    *,
    gamma: int = 2,
    compensation: str = "paper",
    sampler: Optional[Sampler] = None,
) -> Transform:
    """Layerwise-sampling debiasing (Lemma 1) around a base transform.

    Per period, ``gamma`` blocks per family (resampled at each projector
    refresh by ``sampler``) run the base on the compensated full-rank
    gradient; the rest run it on the scaled projected gradient:

      paper    : c_low = 1/(1-q),  c_full = 1/q,  c_comp = 1
      finetune : c_low = 1,        c_full = 1/q,  c_comp = 1-q   (App. C.1)

    Under family stacking the sampling unit is the member leaf: each member
    draws ``gamma`` of its own blocks with its own key, so a stack has
    ``members * gamma`` slots and the same coefficients as the per-leaf path.

    Must be composed inside :func:`lowrank`."""
    if compensation not in ("paper", "finetune"):
        raise ValueError(f"unknown compensation: {compensation}")
    sampler = sampler or generator_sampler

    def _coeffs(fs: FamilyShape, seg=None):
        L_eff = seg.member_L if seg is not None else fs.L
        g_f = min(gamma, L_eff)
        q = g_f / L_eff
        if q >= 1.0:
            c_low = 0.0  # low branch fully overwritten by the scatter
        elif compensation == "finetune":
            c_low = 1.0
        else:
            c_low = 1.0 / max(1.0 - q, 1e-12)
        c_comp = (1.0 - q) if compensation == "finetune" else 1.0
        c_full = (1.0 / q) if g_f > 0 else 0.0
        return g_f, q, c_low, c_comp, c_full

    def init(params: dict) -> LayerwiseUnbiasState:
        lows, fulls, idx = {}, {}, {}
        for k, t in params.items():
            if t is None:
                lows[k] = fulls[k] = idx[k] = None
                continue
            if not isinstance(t, ProjInit):
                raise TypeError("layerwise_unbias must be composed inside lowrank() "
                                f"(init saw a {type(t).__name__} leaf)")
            g_f, q, *_ = _coeffs(t.fs, t.seg)
            device = t.low.device
            # q >= 1: the scatter overwrites the whole family, so the low
            # branch carries no state for this leaf.
            lows[k] = None if q >= 1.0 else t
            if g_f == 0:
                fulls[k] = idx[k] = None
                continue
            ids = torch.arange(g_f, device=device)
            if t.seg is not None:  # g_f slots per member, offset to the stack
                offs = t.seg.member_L * torch.arange(t.seg.members, device=device)
                ids = (ids[None, :] + offs[:, None]).reshape(-1)
            fulls[k] = TensorSpec((len(ids), t.fs.m, t.fs.n), device)
            idx[k] = ids
        return LayerwiseUnbiasState(low=base.init(lows), full=base.init(fulls), idx=idx)

    def _sample(msg, g_f: int, device: torch.device) -> torch.Tensor:
        """Fresh slot -> block ids for a ProjGrad or RefreshMsg: ``g_f`` per
        member, offset to the stack.  On the ``meta`` device (the static
        audit's shape-only trace) nothing is drawn: the sampler may hold
        state that a trace must not move."""
        if torch.device(device).type == "meta":
            members = msg.seg.members if msg.seg is not None else 1
            return torch.empty(members * g_f, dtype=torch.long, device=device)
        if msg.seg is None:
            fresh = sampler(msg.key, msg.fs.L, g_f)
        else:
            mL = msg.seg.member_L
            fresh = torch.cat([sampler(key, mL, g_f).to(torch.long) + j * mL
                               for j, key in enumerate(msg.key)])
        return fresh.to(device=device, dtype=torch.long)

    def update(updates: dict, state: LayerwiseUnbiasState, params: dict):
        """The base on the low branch and on the full-rank slots.  Under
        :func:`family_sharding` (leaves carrying a :class:`ShardView`; the
        state in the layout of :func:`shard_family_state`) the low branch
        runs on the rank's rows.  Every rank draws every slot from the same
        keys; it computes the slots of its share of the ``(slots, m, n)``
        state (all of them where that does not split) from the whole
        gradient.  Where the family's members divide the ranks, those slots'
        blocks lie in the rank's rows and land there; otherwise they travel
        with the rows through ``lowrank``'s gather."""
        low_upds, new_idx, full_upds, full_params, new_proj, plans = {}, {}, {}, {}, {}, {}
        refresh_any = sharded = False
        for k, g in updates.items():
            if g is None:
                low_upds[k] = new_idx[k] = full_upds[k] = full_params[k] = new_proj[k] = None
                continue
            if not isinstance(g, ProjGrad):
                raise TypeError("layerwise_unbias must be composed inside lowrank() "
                                f"(got a {type(g).__name__} leaf)")
            fs, sh = g.fs, g.shard
            sharded = sharded or sh is not None
            split = sh is not None and sh.split
            g_f, q, c_low, c_comp, c_full = _coeffs(fs, g.seg)
            low_upds[k] = g.with_coeff(c_low) if q < 1.0 else None
            new_proj[k] = None
            if g_f == 0:
                new_idx[k] = full_upds[k] = full_params[k] = None
                continue
            idx, fresh = state.idx[k], None
            if g.refresh:
                refresh_any = True
                # a split family reads the draws on the host (_slot_projectors)
                fresh = _sample(g, g_f, torch.device("cpu") if split else g.g.device)
                idx = fresh.to(g.g.device)
            new_idx[k] = idx
            (c, d), slots_split = _split_rows(idx.shape[0], *((sh.k, sh.n) if sh else (0, 1)))
            ids = idx[c:d]
            if not split:
                p_s = gather_blocks(g.p, ids, fs)        # (slots, s, r)
            elif fresh is not None:
                p_s = new_proj[k] = _slot_projectors(g, fresh[c:d].tolist())
            else:
                p_s = new_proj[k] = state.proj[k]
            g_s = gather_blocks(sh.g_full if split else g.g, ids, fs)   # (slots, m, n)
            pad = g.pad_rank_to
            pptg = dispatch.back_project(
                p_s, dispatch.project(p_s, g_s, side=fs.side, impl=g.kernel_impl,
                                      pad_rank_to=pad),
                side=fs.side, impl=g.kernel_impl, pad_rank_to=pad)
            full_upds[k] = c_full * (g_s - c_comp * pptg)
            full_params[k] = gather_blocks(params[k], ids, fs)
            aligned = split and g.seg is not None and g.seg.members % sh.n == 0
            plans[k] = (ids, slots_split, aligned)

        # Slot -> block assignments change at the boundary, so the slots'
        # base momenta always reset there.
        full_state = _reset_floats(state.full) if refresh_any else state.full
        low_out, new_low = base.update(low_upds, state.low, params)
        full_out, new_full = base.update(full_upds, full_state, full_params)

        outs = {}
        for k, g in updates.items():
            if g is None:
                outs[k] = None
                continue
            fs, sh = g.fs, g.shard
            split = sh is not None and sh.split
            g_f, q, *_ = _coeffs(fs, g.seg)
            if q < 1.0:
                rows = g.back(low_out[k])
            else:
                lead = (sh.rows[1] - sh.rows[0],) if split else fs.lead
                rows = torch.zeros(lead + (fs.m, fs.n), dtype=torch.float32, device=g.g.device)
            if g_f == 0:
                outs[k] = RowsUpdate(rows) if split else FullUpdate(rows)
                continue
            ids, slots_split, aligned = plans[k]
            if not split and not slots_split:
                outs[k] = FullUpdate(scatter_blocks(rows, new_idx[k], full_out[k], fs))
            elif aligned:
                outs[k] = RowsUpdate(rows.index_copy(0, ids - sh.rows[0], full_out[k]))
            elif slots_split:
                outs[k] = RowsUpdate(rows, slots=full_out[k], idx=new_idx[k])
            else:
                outs[k] = RowsUpdate(rows, idx=new_idx[k], slot_vals=full_out[k])
        return outs, LayerwiseUnbiasState(low=new_low, full=new_full, idx=new_idx,
                                          proj=new_proj if sharded else None)

    def refresh_state(state: LayerwiseUnbiasState, msgs: dict) -> LayerwiseUnbiasState:
        """The external refresh (``lowrank``'s ``update.refresh``): resample
        every leaf's slots and zero both branches' momenta."""
        new_idx = {}
        for k, msg in msgs.items():
            idx = state.idx[k]
            if msg is None or idx is None:
                new_idx[k] = idx
                continue
            members = msg.seg.members if msg.seg is not None else 1
            new_idx[k] = _sample(msg, idx.shape[0] // members, idx.device)
        return LayerwiseUnbiasState(low=_reset_floats(state.low),
                                    full=_reset_floats(state.full), idx=new_idx)

    def _slot_projectors(g: ProjGrad, ids: list[int]) -> torch.Tensor:
        """A refresh's projectors of the blocks ``ids``: this rank's fresh
        rows where a block lies in them, computed by the family's
        ``project_blocks`` where it does not."""
        (a, b), sh = g.shard.rows, g.shard
        out = torch.empty((len(ids),) + tuple(g.p.shape[1:]), dtype=g.p.dtype,
                          device=g.p.device)
        mine = [i for i, blk in enumerate(ids) if a <= blk < b]
        theirs = [i for i, blk in enumerate(ids) if not a <= blk < b]
        if mine:
            out[mine] = g.p[[ids[i] - a for i in mine]]
        if theirs:
            out[theirs] = sh.project_blocks([ids[i] for i in theirs])
        return out

    update.wants_params = True  # gathers the sampled blocks' params
    update.refresh_state = refresh_state
    update.chain_info = {"kind": "layerwise_unbias", "inner": chain_info(base),
                         "gamma": gamma, "compensation": compensation}
    return Transform(init, update)


# ---------------------------------------------------------------------------
# with_fira_residual — Fira's out-of-subspace residual, as a combinator
# ---------------------------------------------------------------------------


class FiraResidualState(NamedTuple):
    inner: PyTree
    prev_norm: dict  # per-leaf (*lead,) norm-growth-limiter memory


def with_fira_residual(base: Transform, *, limiter: float = 1.01,
                       eps: float = 1e-8) -> Transform:
    """Fira (Chen et al., 2024): add back the gradient component outside the
    projected subspace, scaled per block by phi = ||s|| / ||PᵀG|| (s the
    base's projected-space update), under the norm-growth limiter: a
    block's scaled residual norm may grow at most ``limiter``-fold a step.
    Per leaf it projects once (``ProjGrad.materialize``) and back-projects
    twice (the residual and the update).  Must be composed inside
    :func:`lowrank`; no unbiasedness guarantee (the paper's point of
    comparison).  Under :func:`family_sharding` a split family runs on the
    rank's rows, and the rows of its ``(L,)`` norm memory (replicated by
    the state rule) ride in ``lowrank``'s update all-gather, so every rank
    writes the whole vector."""

    def init(params: dict) -> FiraResidualState:
        return FiraResidualState(
            inner=base.init(params),
            prev_norm={k: None if t is None
                       else torch.zeros(t.fs.lead, dtype=torch.float32, device=t.low.device)
                       for k, t in params.items()})

    def update(updates: dict, state: FiraResidualState, params: dict):
        r_gs, reset = {}, False
        for k, g in updates.items():
            if g is None:
                r_gs[k] = None
                continue
            if not isinstance(g, ProjGrad):
                raise TypeError("with_fira_residual must be composed inside lowrank() "
                                f"(got a {type(g).__name__} leaf)")
            reset = reset or g.reset
            r_gs[k] = g.materialize()

        # The base sees plain tensors, so lowrank's reset never reaches it:
        # honour reset_on_refresh here.
        inner_state, prev_norm = state.inner, state.prev_norm
        if reset:
            inner_state, prev_norm = _reset_floats(inner_state), _reset_floats(prev_norm)
        s_out, new_inner = base.update(r_gs, inner_state, params)

        outs, new_pn = {}, {}
        for k, g in updates.items():
            if g is None:
                outs[k], new_pn[k] = None, prev_norm[k]
                continue
            r_g, s, prev = r_gs[k], s_out[k], prev_norm[k]
            split = g.shard is not None and g.shard.split
            if split:  # this rank's rows [a, b) of the stack
                prev = prev[g.shard.rows[0]:g.shard.rows[1]]
            resid = g.g - g.back(r_g)
            phi = (torch.linalg.vector_norm(s, dim=(-2, -1))
                   / (torch.linalg.vector_norm(r_g, dim=(-2, -1)) + eps))
            scaled = phi[..., None, None] * resid
            rnorm = torch.linalg.vector_norm(scaled, dim=(-2, -1))
            cap = torch.where(prev > 0, limiter * prev, rnorm)
            shrink = torch.clamp(cap / (rnorm + eps), max=1.0)
            u = g.back(s) + shrink[..., None, None] * scaled
            if split:
                # the (L,) memory stays whole on every rank: its rows ride in
                # lowrank's one update all-gather and land in new_pn[k]
                new_pn[k] = torch.empty_like(prev_norm[k])
                outs[k] = RowsUpdate(u, riders=[(rnorm * shrink, new_pn[k])])
            else:
                new_pn[k] = rnorm * shrink
                outs[k] = FullUpdate(u)
        return outs, FiraResidualState(inner=new_inner, prev_norm=new_pn)

    if getattr(base.update, "wants_params", False):
        update.wants_params = True
    update.chain_info = {"kind": "with_fira_residual", "inner": chain_info(base)}
    return Transform(init, update)


# ---------------------------------------------------------------------------
# state introspection
# ---------------------------------------------------------------------------


def find_lowrank_states(state: PyTree) -> list[LowRankState]:
    """Every :class:`LowRankState` inside an optimizer state, in tree order
    (tests and the smoke read projectors through this instead of guessing
    chain indices)."""
    return find_nodes(state, LowRankState)


def is_family_state(st: LowRankState) -> bool:
    """Whether a :class:`LowRankState` is family-stacked (its projectors keyed
    by family index) rather than per leaf (keyed by parameter path)."""
    return (isinstance(st.projs, dict) and bool(st.projs)
            and all(isinstance(k, int) for k in st.projs))


def map_nodes(fn: Callable, tree: PyTree, cls: type) -> PyTree:
    """``tree`` with ``fn`` applied to every node of type ``cls``."""
    if isinstance(tree, cls):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_nodes(fn, v, cls) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_nodes(fn, v, cls) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_nodes(fn, v, cls) for v in tree)
    return tree


def find_nodes(tree: PyTree, cls: type) -> list:
    """Every node of type ``cls`` in ``tree``, in tree order (not looking
    inside one)."""
    found: list = []
    map_nodes(lambda node: found.append(node) or node, tree, cls)
    return found


def shard_family_state(opt_state: PyTree, mesh) -> PyTree:
    """This rank's share of an optimizer state in the whole (replicated)
    layout, for :func:`family_sharding`: every tensor that
    :func:`repro_torch.sharding.family_state_sharding` splits keeps this
    rank's rows, and each ``layerwise_unbias`` state inside a family-stacked
    ``LowRankState`` gains ``proj``, the projectors of its slots' blocks
    where the family's projector rows split.  Used at init, on restore (the
    checkpoint holds the whole layout) and on a rank migration's template."""
    from repro_torch.sharding import family_state_sharding, split_tree

    n = family_shard_count(mesh)
    if n <= 1:
        return opt_state
    k = mesh.coordinate(mesh.data_axis)
    local = split_tree(opt_state, family_state_sharding(opt_state, mesh, mesh.data_axis), mesh)
    whole = iter(find_nodes(opt_state, LowRankState))

    def with_slot_projs(st: LowRankState) -> LowRankState:
        full = next(whole)
        if not is_family_state(st):
            return st
        idx_of = iter(u.idx for u in find_nodes(full.inner, LayerwiseUnbiasState))

        def attach(u: LayerwiseUnbiasState) -> LayerwiseUnbiasState:
            proj = {}
            for fi, idx in next(idx_of).items():
                p = full.projs.get(fi)
                if idx is None or p is None or not _split_rows(p.shape[0], k, n)[1]:
                    proj[fi] = None
                    continue
                (c, d), _ = _split_rows(idx.shape[0], k, n)
                proj[fi] = p[idx[c:d]].clone()
            return u._replace(proj=proj)

        return st._replace(inner=map_nodes(attach, st.inner, LayerwiseUnbiasState))

    return map_nodes(with_slot_projs, local, LowRankState)


def strip_slot_projectors(opt_state: PyTree) -> PyTree:
    """``opt_state`` without the slot projectors :func:`shard_family_state`
    adds (the state the sharding rule splits)."""
    return map_nodes(lambda u: u._replace(proj=None), opt_state, LayerwiseUnbiasState)


def slot_projector_bytes(opt_state: PyTree) -> int:
    """Bytes of the slot projectors a rank's share holds."""
    return sum(p.numel() * p.element_size() for u in find_nodes(opt_state, LayerwiseUnbiasState)
               if u.proj is not None for p in u.proj.values() if p is not None)
