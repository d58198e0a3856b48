"""Primitive layers: RMSNorm and LayerNorm, rotary embeddings (full,
partial and ChatGLM's 2-D), the MLP variants (SwiGLU, GeGLU, GELU, squared
ReLU) with optional biases, the unembedding and the truncated-normal
initializer (as the JAX package's ``models/layers.py``).  Each layer
computes in its input's dtype, casting each weight to it at its use, and
the norm computes in fp32 and casts back.  On a model axis
(:mod:`repro_torch.models.tensor_parallel`) the MLP runs column-parallel
then row-parallel and the unembedding gives this rank's vocab columns."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import tensor_parallel


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """In-place ``std * truncated_normal(-2, 2)``, the reference's init.  A
    leaf stored below fp32 (``param_dtype``) is drawn whole in fp32 and cast,
    as the reference casts its fp32 draw, so it holds the fp32 leaf's draw,
    rounded; the fp32 copy lives for one leaf at a time (18.9 GB for
    nemotron-4-340b's embedding)."""
    with torch.no_grad():
        draw = t if t.dtype == torch.float32 else torch.empty_like(t, dtype=torch.float32)
        torch.nn.init.trunc_normal_(draw, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                    generator=generator)
        draw.mul_(std)
        return t if draw is t else t.copy_(draw)


def apply_norm(x: torch.Tensor, p: dict[str, torch.Tensor], cfg: ModelConfig,
               eps: float = 1e-6) -> torch.Tensor:
    """The reference's ``apply_norm`` with one norm's parameters ``p``, in
    fp32, cast back to x's dtype: LayerNorm (population variance, ``eps``
    inside the rsqrt, then ``norm_scale`` and ``norm_bias``) when
    ``cfg.norm == "layernorm"``, else RMSNorm (``norm_scale``)."""
    x32 = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
        out = (x32 - mu) * torch.rsqrt(var + eps) * p["norm_scale"] + p["norm_bias"]
    else:
        ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
        out = x32 * torch.rsqrt(ms + eps) * p["norm_scale"]
    return out.to(x.dtype)


def rope_angles(positions: torch.Tensor, dim: int, theta: float):
    """cos/sin tables for ``dim`` rotary dims at integer ``positions``."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * inv_freq  # (..., dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Rotary embedding on (..., S, H, hd), interleaved pairs (0::2, 1::2)
    of the leading ``rot`` head dims; the rest pass through.  ``rot`` is
    ``hd * rope_fraction`` (half for ChatGLM's ``rope2d``) rounded down to
    even, and the frequencies run over ``rot``."""
    if cfg.rope == "none":
        return x
    hd = x.shape[-1]
    rot = int(hd * (0.5 if cfg.rope == "rope2d" else cfg.rope_fraction))
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    cos, sin = rope_angles(positions, rot, cfg.rope_theta)  # (..., S, rot/2)
    cos, sin = cos[..., :, None, :], sin[..., :, None, :]  # broadcast over heads
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(xr.shape)
    return torch.cat([out, xp], dim=-1).to(x.dtype)


def mlp_act(h: torch.Tensor, g: Optional[torch.Tensor], act: str) -> torch.Tensor:
    """The MLP's activation; GELU is the tanh form, as ``jax.nn.gelu``'s
    default."""
    if act == "swiglu":
        return F.silu(g) * h
    if act == "geglu":
        return F.gelu(g, approximate="tanh") * h
    if act == "gelu":
        return F.gelu(h, approximate="tanh")
    if act == "relu2":  # squared ReLU (Primer / Nemotron-4)
        r = F.relu(h)
        return r * r
    raise ValueError(f"unknown act {act}")


def apply_mlp(x: torch.Tensor, p: dict[str, torch.Tensor], act: str) -> torch.Tensor:
    """``act(x w_in + bias_in[, x w_gate]) w_out + bias_out`` with one
    layer's weights ``p`` (``w_gate`` for the gated acts, the biases where
    the config has them).  On a model axis: this rank's columns of
    ``w_in`` / ``w_gate`` (and of ``bias_in``), its rows of ``w_out``, the
    partial products summed over the axis before ``bias_out``."""
    tp = tensor_parallel.active()
    if tp is not None:
        x = tensor_parallel.enter(tp, x)
    h = x @ p["w_in"].to(x.dtype)
    if "bias_in" in p:
        h = h + tensor_parallel.local(tp, p["bias_in"], h.shape[-1]).to(x.dtype)
    g = x @ p["w_gate"].to(x.dtype) if "w_gate" in p else None
    out = mlp_act(h, g, act) @ p["w_out"].to(x.dtype)
    if tp is not None:
        out = tensor_parallel.leave(tp, out)
    if "bias_out" in p:
        out = out + p["bias_out"].to(x.dtype)
    return out


def unembed(x: torch.Tensor, embed: torch.Tensor, lm_head=None) -> torch.Tensor:
    """Logits in x's dtype: the tied unembedding ``x @ embedᵀ``, or the
    untied head ``x @ lm_head`` (d, vocab) when there is one.  On a model
    axis: this rank's vocab columns (from its rows of the table), and ``x``'s
    gradient summed over the axis."""
    tp = tensor_parallel.active()
    if tp is not None:
        x = tensor_parallel.enter(tp, x)
    if lm_head is None:
        return x @ embed.to(x.dtype).T
    return x @ lm_head.to(x.dtype)
