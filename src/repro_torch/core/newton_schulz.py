"""Newton–Schulz orthogonalization (msign) used by Muon.

Newton–Schulz approximates ``msign(X) = U Vᵀ`` for ``X = U Σ Vᵀ`` with
Keller Jordan's quintic iteration, coefficients (a, b, c) = (3.4445, -4.7750,
2.0315), 5 steps, in fp32.

:func:`newton_schulz_plain` is the plain iteration.  The optimizer calls
:func:`repro_torch.kernels.dispatch.newton_schulz`, which runs the CUDA
kernels for CUDA tensors and this plain iteration for CPU tensors.
"""
from __future__ import annotations

import torch

NS_COEFFS = (3.4445, -4.7750, 2.0315)
NS_STEPS = 5


def newton_schulz_plain(x: torch.Tensor, *, steps: int = NS_STEPS,
                        eps: float = 1e-7) -> torch.Tensor:
    """The plain quintic iteration on (..., m, n), in fp32; iterates on the
    transposed problem when m > n so the Gram matrix XXᵀ is the small side.
    The reference the CUDA path is held against."""
    a, b, c = NS_COEFFS
    orig_dtype = x.dtype
    x = x.to(torch.float32)

    transposed = x.shape[-2] > x.shape[-1]
    if transposed:
        x = x.mT

    # Frobenius normalisation so the singular values land in the basin.
    x = x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True) + eps)
    for _ in range(steps):
        xxt = x @ x.mT                       # (..., m, m), m <= n
        x = a * x + (b * xxt + c * (xxt @ xxt)) @ x

    if transposed:
        x = x.mT
    return x.to(orig_dtype)


def muon_scale(shape: tuple[int, int]) -> float:
    """Muon's shape-dependent update scale sqrt(max(1, m/n)): keeps the RMS
    of the orthogonalized update comparable across aspect ratios."""
    m, n = shape[-2], shape[-1]
    return max(1.0, m / n) ** 0.5
