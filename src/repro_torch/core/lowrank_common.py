"""Shared machinery for blockwise low-rank optimizers.

A *family* is one parameter of shape ``(*lead, m, n)`` whose leading dims are
stacked blocks (layer-stacked ``(L, m, n)``).  The projector ``P`` acts on the
shorter side, as in GaLore:

  left  (m <= n): state = Pᵀ G in (*lead, r, n);  back-projection  P @ S
  right (m >  n): state = G P in (*lead, m, r);   back-projection  S @ Pᵀ

``project`` / ``back_project`` here are the plain einsums; the optimizer's
hot path goes through :mod:`repro_torch.kernels.dispatch` instead.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class FamilyShape(NamedTuple):
    lead: tuple[int, ...]  # leading block dims
    L: int                 # total block count = prod(lead)
    m: int
    n: int
    side: str              # "left" | "right"
    rank: int


def family_shape(p: torch.Tensor, rank: int) -> FamilyShape:
    """Geometry of one family at an integer ``rank`` (clipped to min(m, n))."""
    if not isinstance(rank, int):
        raise NotImplementedError("per-family rank maps are not ported yet; "
                                  "pass an int rank")
    if p.dim() < 2:
        raise ValueError(f"low-rank families need >=2 dims, got {tuple(p.shape)}")
    m, n = int(p.shape[-2]), int(p.shape[-1])
    lead = tuple(int(d) for d in p.shape[:-2])
    L = 1
    for d in lead:
        L *= d
    side = "left" if m <= n else "right"
    return FamilyShape(lead=lead, L=L, m=m, n=n, side=side, rank=min(rank, m, n))


def proj_dim(fs: FamilyShape) -> int:
    """Dim P projects: m for left, n for right."""
    return fs.m if fs.side == "left" else fs.n


def proj_shape(fs: FamilyShape) -> tuple[int, ...]:
    return fs.lead + (proj_dim(fs), fs.rank)


def lowrank_state_shape(fs: FamilyShape) -> tuple[int, ...]:
    """(*lead, r, n) for left, (*lead, m, r) for right."""
    if fs.side == "left":
        return fs.lead + (fs.rank, fs.n)
    return fs.lead + (fs.m, fs.rank)


def project(p: torch.Tensor, g: torch.Tensor, side: str) -> torch.Tensor:
    """Low-rank projection. p: (*lead, s, r), g: (*lead, m, n)."""
    if side == "left":
        return torch.einsum("...mr,...mn->...rn", p, g)
    return torch.einsum("...mn,...nr->...mr", g, p)


def back_project(p: torch.Tensor, s: torch.Tensor, side: str) -> torch.Tensor:
    """Back-projection of low-rank states to (*lead, m, n)."""
    if side == "left":
        return torch.einsum("...mr,...rn->...mn", p, s)
    return torch.einsum("...mr,...nr->...mn", s, p)


def gather_blocks(x: torch.Tensor, idx: torch.Tensor, fs: FamilyShape) -> torch.Tensor:
    """(*lead, a, b) -> (gamma, a, b): the blocks at flat ids ``idx``."""
    if not fs.lead:  # single-block family: gamma is necessarily 1
        return x[None]
    return x.reshape((fs.L,) + tuple(x.shape[-2:]))[idx]


def scatter_blocks(x: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                   fs: FamilyShape) -> torch.Tensor:
    """A copy of ``x`` with the blocks at flat ids ``idx`` set to ``vals``."""
    if not fs.lead:
        return vals[0]
    out = x.reshape((fs.L,) + tuple(x.shape[-2:])).index_copy(0, idx, vals)
    return out.reshape(x.shape)


def compute_projectors(kind: str, g: torch.Tensor, rank: int, side: str) -> torch.Tensor:
    """Batched per-block projectors ``(*lead, s, rank)`` with orthonormal
    columns (Property I): the top-``rank`` left singular vectors of each
    block (of Gᵀ on the right side), by ``torch.linalg.svd``."""
    if kind != "svd":
        raise NotImplementedError(f"projector {kind!r} is not ported yet (svd only)")
    if side == "right":
        g = g.mT
    u, _, _ = torch.linalg.svd(g.to(torch.float32), full_matrices=False)
    return u[..., :, :rank].contiguous()


def default_lowrank_filter(path: str, p) -> bool:
    """Which leaves get low-rank treatment: hidden matrices (attention + MLP
    kernels).  Embeddings / head / norms / biases / routers / conv taps /
    per-layer vector stacks fall through to the fallback optimizer."""
    if p.dim() < 2:
        return False
    if min(int(p.shape[-1]), int(p.shape[-2])) < 8:
        return False  # per-layer vectors stacked into 2-D, conv taps, gates
    lowered = path.lower()
    return not any(
        k in lowered
        for k in ("embed", "lm_head", "norm", "scale", "bias",
                  "conv_w", "skip_d", "a_log", "router")
    )
