"""Newton–Schulz orthogonalization on the port's CUDA kernels.

One quintic step is ``X' = a·X + (b·G + c·G²) @ X`` with ``G = X Xᵀ``.  As in
the JAX package's ``kernels/newton_schulz.py`` the step is split into two
kernels and a small polynomial:

  1. :func:`gram`             — ``G = X Xᵀ``       (``csrc/gram.cu``)
  2. :func:`poly_matmul_axpy` — ``a·X + A2 @ X``   (``csrc/poly_apply.cu``)

both on the 3xTF32 tensor-core core ``csrc/tf32x3_gemm.cuh`` (``gram``
computes one triangle and mirrors it, so its output is exactly symmetric);
``A2 = b·G + c·G@G`` on the ``(s, s)`` Gram stays a ``torch.matmul``, as
it stays in XLA in the reference.  Each wrapper runs its kernel for CUDA
tensors and the plain version (:mod:`repro_torch.kernels.ref`) for CPU
tensors only.  Inputs are ``(L, s, n)`` with ``s <= n``; the transposition
for ``s > n`` lives in :func:`repro_torch.kernels.dispatch.newton_schulz`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref


def gram(x: torch.Tensor) -> torch.Tensor:
    """``X Xᵀ`` for X (L, s, n)."""
    if x.device.type == "cpu":
        return ref.gram_ref(x)
    build.check_operands(x.device, x=x)
    L, s, n = x.shape
    out = torch.empty((L, s, s), device=x.device, dtype=torch.float32)
    build.launch("gram", x.device, x.data_ptr(), out.data_ptr(), L, s, n)
    return out


def gram_tile(L: int, s: int, n: int) -> tuple[int, int]:
    """The square block tile the ``gram`` kernel picks for X (L, s, n)
    (``build.tile``; launches nothing)."""
    return build.tile("gram", L, s, n)


def poly_matmul_axpy(a2: torch.Tensor, x: torch.Tensor, a: float) -> torch.Tensor:
    """``a·X + A2 @ X`` for A2 (L, s, s), X (L, s, n)."""
    if x.device.type == "cpu":
        return ref.poly_matmul_axpy_ref(a2, x, a)
    build.check_operands(x.device, a2=a2, x=x)
    L, s, n = x.shape
    if a2.shape != (L, s, s):
        raise ValueError(f"shape mismatch: a2 {tuple(a2.shape)}, x {tuple(x.shape)}")
    out = torch.empty((L, s, n), device=x.device, dtype=torch.float32)
    build.launch("poly_apply", x.device, a2.data_ptr(), x.data_ptr(), out.data_ptr(),
                 L, s, n, float(a))
    return out


def poly_apply_tile(L: int, s: int, n: int) -> tuple[int, int]:
    """The block tile the ``poly_apply`` kernel picks for A2 (L, s, s),
    X (L, s, n) (``build.tile``; launches nothing)."""
    return build.tile("poly_apply", L, s, n)


def ns_iteration(x: torch.Tensor) -> torch.Tensor:
    """One quintic NS step through the two kernels (fp32, (L, s, n))."""
    # imported here: repro_torch.core imports the dispatcher, which imports
    # this module, so a top-level import fails when this module comes first
    from repro_torch.core.newton_schulz import NS_COEFFS

    a, b, c = NS_COEFFS
    g = gram(x)
    a2 = b * g + c * (g @ g)  # (L, s, s): small, stays a plain matmul
    return poly_matmul_axpy(a2, x, a)


def newton_schulz_cuda(x: torch.Tensor, *, steps: int = 5, eps: float = 1e-7) -> torch.Tensor:
    """Newton–Schulz on a stacked ``(L, s, n)`` family with ``s <= n``:
    Frobenius normalisation, then ``steps`` kernel iterations."""
    x = x.to(torch.float32)
    x = x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True) + eps)
    for _ in range(steps):
        x = ns_iteration(x)
    return x
