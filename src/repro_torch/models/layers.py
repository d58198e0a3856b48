"""Primitive layers: RMSNorm, rotary embeddings, SwiGLU, the unembedding
and the truncated-normal initializer (as the JAX package's
``models/layers.py``, the subset the dense and ssm families use).  Each
layer computes in its input's dtype, and the norm casts back to it."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """In-place ``std * truncated_normal(-2, 2)``, the reference's init."""
    with torch.no_grad():
        torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                    generator=generator)
        return t.mul_(std)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 (the reference's ``apply_norm``), cast back to x's dtype."""
    x32 = x.to(torch.float32)
    ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * scale).to(x.dtype)


def rope_angles(positions: torch.Tensor, dim: int, theta: float):
    """cos/sin tables for ``dim`` rotary dims at integer ``positions``."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * inv_freq  # (..., dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Rotary embedding on (..., S, H, hd), interleaved pairs (0::2, 1::2)."""
    if cfg.rope == "none":
        return x
    if cfg.rope != "rope" or cfg.rope_fraction != 1.0:
        raise NotImplementedError(f"rope={cfg.rope!r} (fraction {cfg.rope_fraction}) "
                                  "is not ported yet")
    hd = x.shape[-1]
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)  # (..., S, hd/2)
    cos, sin = cos[..., :, None, :], sin[..., :, None, :]  # broadcast over heads
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def swiglu_mlp(x: torch.Tensor, w_in: torch.Tensor, w_gate: torch.Tensor,
               w_out: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_in)) @ w_out


def unembed(x: torch.Tensor, embed: torch.Tensor, lm_head=None) -> torch.Tensor:
    """Logits in x's dtype: the tied unembedding ``x @ embedᵀ``, or the
    untied head ``x @ lm_head`` (d, vocab) when there is one."""
    if lm_head is None:
        return x @ embed.to(x.dtype).T
    return x @ lm_head.to(x.dtype)
