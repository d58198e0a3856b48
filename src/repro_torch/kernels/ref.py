"""Plain PyTorch versions of every op on the port's path.

Each kernel wrapper in :mod:`lowrank_update`, :mod:`fused_step` and
:mod:`newton_schulz` runs the matching function here when its tensors lie
on the CPU, and ``chip_smoke.py`` holds each CUDA kernel against it on the
card.  All functions compute in fp32 and accept a leading batch:
``(..., a, b)``.

Shapes convention (as in the JAX package's ``kernels/ref.py``):
  attention:      q (B, S, H, D), k/v (B, T, KV, D), GQA via H % KV == 0
  newton-schulz:  x (..., m, n)
  lowrank update: p (..., m, r), g (..., m, n), r_state (..., r, n)
  epilogue:       p (..., m, r), s (..., r, n), w (..., m, n) or None
"""
from __future__ import annotations

from typing import Optional

import torch


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


# ------------------------------------------------------------ attention


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention with GQA and fp32 softmax.  Under ``causal`` the S
    queries are the last S positions of the T-long kv sequence (row offset
    ``T - S``)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qg = _f32(q).reshape(B, S, KV, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, _f32(k)) * scale
    if causal:
        rows = torch.arange(S, device=q.device)[:, None] + (T - S)
        mask = torch.arange(T, device=q.device)[None, :] <= rows
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, _f32(v))
    return o.reshape(B, S, H, D).to(q.dtype)


# ------------------------------------------------------------ newton-schulz


def gram_ref(x: torch.Tensor) -> torch.Tensor:
    """X Xᵀ."""
    x = _f32(x)
    return x @ x.mT


def poly_matmul_axpy_ref(a2: torch.Tensor, x: torch.Tensor, a: float) -> torch.Tensor:
    """a X + A2 @ X (the second half of an NS iteration)."""
    return a * _f32(x) + _f32(a2) @ _f32(x)


def ns_iteration_ref(x: torch.Tensor, a: float, b: float, c: float) -> torch.Tensor:
    """One quintic NS iteration: a X + (b XXᵀ + c (XXᵀ)²) X, fp32."""
    x = _f32(x)
    xxt = x @ x.mT
    return a * x + (b * xxt + c * (xxt @ xxt)) @ x


# ------------------------------------------------------------ low-rank update


def lowrank_update_ref(
    p: torch.Tensor, g: torch.Tensor, r_state: Optional[torch.Tensor],
    beta: float, coeff: float,
) -> torch.Tensor:
    """Fused momentum update: R' = beta R + coeff · Pᵀ G (R None: the
    projection coeff · Pᵀ G)."""
    out = coeff * (_f32(p).mT @ _f32(g))
    if r_state is not None:
        out = beta * _f32(r_state) + out
    return out


def project_ref(p: torch.Tensor, g: torch.Tensor, coeff: float = 1.0) -> torch.Tensor:
    """Projection: coeff · Pᵀ G."""
    return lowrank_update_ref(p, g, None, 0.0, coeff)


def back_project_ref(p: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Back-projection GEMM: P (..., m, r) @ S (..., r, n) -> (..., m, n)."""
    return _f32(p) @ _f32(s)


def back_project_epilogue_ref(
    p: torch.Tensor, s: torch.Tensor, w: Optional[torch.Tensor], scale: float,
    decay: float,
) -> torch.Tensor:
    """Fused write-back: scale·(P @ S) + decay·W (W optional)."""
    out = scale * (_f32(p) @ _f32(s))
    if w is not None:
        out = out + decay * _f32(w)
    return out
