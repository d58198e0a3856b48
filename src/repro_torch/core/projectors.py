"""Low-rank projector constructions on one block ``G (m, n)``.

Every projector returns ``P (m, r)`` with orthonormal columns (Property I of
the paper: ``PᵀP = I_r``), which is all the unbiased paradigm needs; the
choice of subspace only changes how much gradient energy the low-rank
branch captures.

  * ``svd``       — GaLore's top-r left singular vectors.
  * ``subspace``  — randomized subspace iteration, QR between power steps.
  * ``rsvd``      — randomized range finder: one Gaussian sketch and one
                    QR (the subspace projector with zero iterations).
  * ``random``    — GoLore's projector: an orthonormalized Gaussian,
                    independent of the gradient.
  * ``grass``     — rows sampled ∝ row norms (Gumbel top-k); the columns
                    are one-hot.

Each is :func:`repro_torch.core.lowrank_common.compute_projectors` at an
empty lead on the left side — the batched form the optimizer runs — so the
math lives in one place.  ``key`` and ``noise`` are that function's: the
random draws come from ``noise(key, kind, shape)``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.lowrank_common import Noise, compute_projectors

PROJECTOR_KINDS = ("svd", "subspace", "rsvd", "random", "grass")


def projection_side(shape: tuple[int, int]) -> str:
    """GaLore projects the smaller dimension: 'left' if m <= n else 'right'.

    'left'  : P (m, r); the low-rank state is Pᵀ G (r, n)
    'right' : P (n, r); the low-rank state is G P  (m, r)
    """
    m, n = shape
    return "left" if m <= n else "right"


def _one_block(kind, g, rank, key, noise, subspace_iters=2):
    if g.dim() != 2:
        raise ValueError(f"one block (m, n) expected, got {tuple(g.shape)}")
    return compute_projectors(kind, g, rank, "left", key=key,
                              subspace_iters=subspace_iters, noise=noise)


def svd_projector(g: torch.Tensor, rank: int) -> torch.Tensor:
    """Top-``rank`` left singular vectors of ``g``."""
    return _one_block("svd", g, rank, None, None)


def subspace_projector(g: torch.Tensor, rank: int, key, *, iters: int = 2,
                       noise: Optional[Noise] = None) -> torch.Tensor:
    """orth((G Gᵀ)^iters G Ω), Ω Gaussian (n, r)."""
    return _one_block("subspace", g, rank, key, noise, subspace_iters=iters)


def rsvd_projector(g: torch.Tensor, rank: int, key, *,
                   noise: Optional[Noise] = None) -> torch.Tensor:
    """orth(G Ω): the randomized range finder (Halko et al.)."""
    return _one_block("rsvd", g, rank, key, noise)


def random_projector(shape: tuple[int, int], rank: int, key, *,
                     noise: Optional[Noise] = None,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """GoLore's gradient-independent projector: orth(Z), Z Gaussian (m, r)."""
    # only the shape and device are read: a zero-stride view, nothing allocated
    g = torch.empty((), device=device).expand(shape)
    return _one_block("random", g, rank, key, noise)


def grass_projector(g: torch.Tensor, rank: int, key, *,
                    noise: Optional[Noise] = None) -> torch.Tensor:
    """``rank`` rows of ``g`` sampled without replacement ∝ their norms, as
    one-hot columns."""
    return _one_block("grass", g, rank, key, noise)


def make_projector(kind: str, g: torch.Tensor, rank: int, key=None, *,
                   subspace_iters: int = 2,
                   noise: Optional[Noise] = None) -> torch.Tensor:
    """Any kind on one block: ``(m, rank)`` with orthonormal columns."""
    if kind not in PROJECTOR_KINDS:
        raise ValueError(f"unknown projector kind: {kind!r}")
    return _one_block(kind, g, rank, key, noise, subspace_iters=subspace_iters)
