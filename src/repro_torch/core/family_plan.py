"""Static family plan: group same-shape leaves into stacked super-leaves.

With ``lowrank(fuse_families=True)`` every leaf with the same *family
signature* ``(lead, m, n, side, rank, dtype)`` joins one stacked
``(M·prod(lead), m, n)`` super-leaf, so the optimizer pipeline runs one
batched launch per shape family instead of one per leaf (llama-130m's seven
hidden leaves become three launch units), then results scatter back to the
member leaves.

Only leaves with IDENTICAL signatures stack: equal ``lead`` keeps the
per-member block count ``L`` — and with it ``layerwise_unbias``'s sampling
ratio ``q = gamma/L`` and compensation coefficients — uniform across the
stack, which is what makes stacked execution trajectory-identical to the
per-leaf path.  Per-member sampling keys are the per-leaf ``(seed, count,
leaf index)`` tuples, kept per member (never merged; see :class:`StackSeg`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.lowrank_common import FamilyShape, family_shape


class StackSeg(NamedTuple):
    """Segment geometry of a stacked super-leaf.

    ``members`` original leaves, each contributing ``member_L`` blocks
    (``member_L = prod(member_lead)``); global block ``j*member_L + b`` is
    block ``b`` of member ``j``.  Carried on ``ProjGrad``/``ProjInit`` leaves
    so ``layerwise_unbias`` samples per *member*, preserving the per-leaf
    trajectories exactly."""

    members: int
    member_L: int


class Family(NamedTuple):
    """One shape family: the stacked geometry plus its member leaf indices."""

    fs: FamilyShape           # stacked: lead = (members * member_L,)
    member_fs: FamilyShape    # geometry of ONE member leaf
    seg: StackSeg
    members: tuple[int, ...]  # flat leaf indices (order of first occurrence)


class FamilyPlan(NamedTuple):
    families: tuple[Family, ...]
    n_leaves: int


def family_signature(p: torch.Tensor, rank) -> tuple:
    """The grouping key: leaves stack iff their signatures are equal.
    ``rank`` may be an int or a per-shape ``RankMap`` (resolved per leaf by
    ``family_shape``); the resolved rank is part of the signature, so a rank
    change re-plans the families — same-(m, n) leaves always share one rank,
    which keeps the grouping itself stable across rank migrations."""
    fs = family_shape(p, rank)
    return (fs.lead, fs.m, fs.n, fs.side, fs.rank, p.dtype)


def build_family_plan(leaves: list, rank) -> FamilyPlan:
    """Group the non-``None`` leaves of a flat params list into families, in
    order of first occurrence (the same for init and every update, which see
    the same params)."""
    groups: dict[tuple, list[int]] = {}
    member_fs: dict[tuple, FamilyShape] = {}
    for i, p in enumerate(leaves):
        if p is None:
            continue
        sig = family_signature(p, rank)
        groups.setdefault(sig, []).append(i)
        member_fs.setdefault(sig, family_shape(p, rank))
    families = []
    for sig, members in groups.items():
        mfs = member_fs[sig]
        seg = StackSeg(members=len(members), member_L=mfs.L)
        stacked = FamilyShape(
            lead=(seg.members * seg.member_L,), L=seg.members * seg.member_L,
            m=mfs.m, n=mfs.n, side=mfs.side, rank=mfs.rank,
        )
        families.append(Family(fs=stacked, member_fs=mfs, seg=seg,
                               members=tuple(members)))
    return FamilyPlan(families=tuple(families), n_leaves=len(leaves))


def plan_stats(plan: FamilyPlan) -> dict:
    """Geometry summary of a plan, JSON-serializable: how the routed leaves
    collapse into launch units."""
    return {
        "n_families": len(plan.families),
        "n_leaves": plan.n_leaves,
        "n_stacked": sum(f.seg.members for f in plan.families),
        "families": [
            f"{f.member_fs.m}x{f.member_fs.n}r{f.member_fs.rank}"
            f"x{f.seg.members}"
            for f in plan.families
        ],
        "stack_dims": [
            [f.fs.L, f.member_fs.m, f.member_fs.n] for f in plan.families
        ],
    }


def stack_family(fam: Family, leaves: list) -> torch.Tensor:
    """Stack member leaves ``(*lead, a, b)`` -> ``(members*member_L, a, b)``.
    Row-major, so member ``j``'s blocks occupy rows
    ``[j*member_L, (j+1)*member_L)``."""
    parts = torch.stack([leaves[i] for i in fam.members])
    return parts.reshape((fam.seg.members * fam.seg.member_L,)
                         + tuple(parts.shape[1 + len(fam.member_fs.lead):]))


def unstack_family(fam: Family, stacked: torch.Tensor) -> list[torch.Tensor]:
    """Inverse of :func:`stack_family` on any ``(members*member_L, *tail)``
    result: per-member ``(*lead, *tail)`` views, in member order."""
    tail = tuple(stacked.shape[1:])
    parts = stacked.reshape((fam.seg.members,) + fam.member_fs.lead + tail)
    return list(parts.unbind(0))


def member_keys(fam: Family, seed: int, count: int) -> list[tuple[int, int, int]]:
    """Per-member sampling keys: the ``(seed, count, leaf index)`` each member
    gets on the per-leaf path."""
    return [(seed, count, i) for i in fam.members]
