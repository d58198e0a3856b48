"""Low-rank optimizer GEMMs: the fused momentum update, the projection and
the back-projection, each over a batch of L family members.

Each wrapper runs its CUDA kernel (``csrc/lowrank_update.cu``,
``csrc/back_project.cu``) for CUDA tensors and the plain version in
:mod:`repro_torch.kernels.ref` for CPU tensors — and takes the plain version
for no other reason: on a CUDA tensor it launches the kernel or raises.  The
kernels mask ragged shapes themselves, so operands need no padding.
Layouts follow the JAX package's ``kernels/lowrank_update.py``:

  lowrank_update_batched  p (L, m, r), g (L, m, n), R (L, r, n) -> (L, r, n)
  project_batched         p (L, m, r), g (L, m, n)              -> (L, r, n)
  back_project_batched    p (L, m, r), s (L, r, n)              -> (L, m, n)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref


def lowrank_update_batched(
    p: torch.Tensor, g: torch.Tensor, r_state: Optional[torch.Tensor],
    beta: float, coeff: float,
) -> torch.Tensor:
    """``beta·R + coeff·PᵀG``; ``r_state=None`` gives ``coeff·PᵀG``."""
    if g.device.type == "cpu":
        return ref.lowrank_update_ref(p, g, r_state, beta, coeff)
    build.check_operands(g.device, p=p, g=g, r_state=r_state)
    L, m, r = p.shape
    n = g.shape[-1]
    if g.shape != (L, m, n) or (r_state is not None and r_state.shape != (L, r, n)):
        raise ValueError(f"shape mismatch: p {tuple(p.shape)}, g {tuple(g.shape)}, "
                         f"r_state {None if r_state is None else tuple(r_state.shape)}")
    out = torch.empty((L, r, n), device=g.device, dtype=torch.float32)
    build.launch("lowrank_update", g.device, p.data_ptr(), g.data_ptr(),
                 None if r_state is None else r_state.data_ptr(),
                 out.data_ptr(), L, m, r, n, float(beta), float(coeff))
    return out


def project_batched(p: torch.Tensor, g: torch.Tensor, coeff: float = 1.0) -> torch.Tensor:
    """``coeff·PᵀG`` — the momentum kernel with no R operand."""
    return lowrank_update_batched(p, g, None, 0.0, coeff)


def back_project_batched(p: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``P @ S``."""
    if s.device.type == "cpu":
        return ref.back_project_ref(p, s)
    build.check_operands(s.device, p=p, s=s)
    L, m, r = p.shape
    n = s.shape[-1]
    if s.shape != (L, r, n):
        raise ValueError(f"shape mismatch: p {tuple(p.shape)}, s {tuple(s.shape)}")
    out = torch.empty((L, m, n), device=s.device, dtype=torch.float32)
    build.launch("back_project", s.device, p.data_ptr(), s.data_ptr(), out.data_ptr(),
                 L, m, r, n)
    return out
