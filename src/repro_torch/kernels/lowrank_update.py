"""Low-rank optimizer GEMMs: the fused momentum update, the projection and
the back-projection, each over a batch of L family members.

Each wrapper runs its CUDA kernel (``csrc/lowrank_update.cu``,
``csrc/back_project.cu``) for CUDA tensors and the plain version in
:mod:`repro_torch.kernels.ref` for CPU tensors — and takes the plain version
for no other reason: on a CUDA tensor it launches the kernel or raises.  The
kernels mask ragged shapes themselves, so operands need no padding.
Layouts follow the JAX package's ``kernels/lowrank_update.py``; all three
also take the right side natively, every operand in the caller's layout:

  lowrank_update_batched  left   p (L, m, r), g (L, m, n), R (L, r, n) -> (L, r, n)
                          right  p (L, n, r), g (L, m, n), R (L, m, r) -> (L, m, r)
  project_batched         the same with no R
  back_project_batched    left   p (L, m, r), s (L, r, n)              -> (L, m, n)
                          right  p (L, n, r), s (L, m, r)              -> (L, m, n)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref


def lowrank_update_batched(
    p: torch.Tensor, g: torch.Tensor, r_state: Optional[torch.Tensor],
    beta: float, coeff: float, *, side: str = "left",
) -> torch.Tensor:
    """``beta·R + coeff·PᵀG`` (left) or ``beta·R + coeff·G P`` (right);
    ``r_state=None`` gives the product times ``coeff``."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    right = side == "right"
    if g.device.type == "cpu":
        if right:  # G P = (Pᵀ Gᵀ)ᵀ
            rt = None if r_state is None else r_state.mT
            return ref.lowrank_update_ref(p, g.mT, rt, beta, coeff).mT
        return ref.lowrank_update_ref(p, g, r_state, beta, coeff)
    build.check_operands(g.device, p=p, g=g, r_state=r_state)
    L, m, n = g.shape
    r = p.shape[-1]
    out_shape = (L, m, r) if right else (L, r, n)
    if p.shape != (L, n if right else m, r) or (
            r_state is not None and r_state.shape != out_shape):
        raise ValueError(f"shape mismatch ({side}): p {tuple(p.shape)}, g {tuple(g.shape)}, "
                         f"r_state {None if r_state is None else tuple(r_state.shape)}")
    out = torch.empty(out_shape, device=g.device, dtype=torch.float32)
    build.launch("lowrank_update", g.device, p.data_ptr(), g.data_ptr(),
                 None if r_state is None else r_state.data_ptr(),
                 out.data_ptr(), L, m, r, n, float(beta), float(coeff), int(right))
    return out


def lowrank_update_tile(L: int, m: int, r: int, n: int, side: str = "left") -> tuple[int, int]:
    """The block tile (rows, columns of the output) that the CUDA kernel
    picks for these shapes, read from the kernel's library; builds the
    kernels on first use and launches nothing."""
    return build.tile("lowrank_update", L, m, r, n, int(side == "right"))


def project_batched(p: torch.Tensor, g: torch.Tensor, coeff: float = 1.0, *,
                    side: str = "left") -> torch.Tensor:
    """``coeff·PᵀG`` / ``coeff·G P`` — the momentum kernel with no R operand."""
    return lowrank_update_batched(p, g, None, 0.0, coeff, side=side)


def back_project_batched(p: torch.Tensor, s: torch.Tensor, *,
                         side: str = "left") -> torch.Tensor:
    """``P S`` (left) or ``S Pᵀ`` (right), contiguous (L, m, n)."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    right = side == "right"
    if s.device.type == "cpu":
        if right:  # S Pᵀ is the left-side product with (S, Pᵀ) as (P, S)
            return ref.back_project_ref(s, p.mT)
        return ref.back_project_ref(p, s)
    build.check_operands(s.device, p=p, s=s)
    L, r = p.shape[0], p.shape[-1]
    m, n = (s.shape[1], p.shape[1]) if right else (p.shape[1], s.shape[-1])
    if s.shape != ((L, m, r) if right else (L, r, n)):
        raise ValueError(f"shape mismatch ({side}): p {tuple(p.shape)}, s {tuple(s.shape)}")
    out = torch.empty((L, m, n), device=s.device, dtype=torch.float32)
    build.launch("back_project", s.device, p.data_ptr(), s.data_ptr(), out.data_ptr(),
                 L, m, r, n, int(right))
    return out


def back_project_tile(L: int, m: int, r: int, n: int, side: str = "left") -> tuple[int, int]:
    """The block tile (rows, columns of the (m, n) output) that the CUDA
    kernel picks for these shapes (``build.tile``; launches nothing)."""
    return build.tile("back_project", L, m, r, n, int(side == "right"))
