"""Mamba-2 (SSD) block: in-proj -> causal depthwise conv -> SSD -> gated norm
-> out-proj (the port of the JAX package's ``models/mamba2.py``).  Sequence
mixing runs through ``ops.ssd`` (the SSD scan kernel at ``attn_impl`` other
than "xla"); decode through ``ops.ssd_decode_step``.  The casts between the
activation dtype and fp32 sit where the reference puts them.

A block's parameters are a dict of one layer's tensors, under the
reference's names: ``ssm_in`` (d, in_dim), ``conv_w`` (W, conv_dim),
``conv_bias``, ``a_log``, ``dt_bias``, ``skip_d``, ``gnorm_scale``,
``ssm_out`` (d_inner, d).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import trunc_normal_


def dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_headdim
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * cfg.ssm_ngroups * N
    return d_inner, H, N, conv_dim


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """One block's parameter shapes by name."""
    d = cfg.d_model
    d_inner, H, N, conv_dim = dims(cfg)
    in_dim = 2 * d_inner + 2 * cfg.ssm_ngroups * N + H
    return {"a_log": (H,), "conv_bias": (conv_dim,), "conv_w": (cfg.ssm_conv, conv_dim),
            "dt_bias": (H,), "gnorm_scale": (d_inner,), "skip_d": (H,),
            "ssm_in": (d, in_dim), "ssm_out": (d_inner, d)}


def init_mamba_block(p: dict[str, torch.Tensor], cfg: ModelConfig,
                     gen: torch.Generator) -> None:
    """Initialise one block's (or a layer stack's) parameters in place with
    the reference's distributions and constants."""
    d = cfg.d_model
    d_inner, H, _, _ = dims(cfg)
    trunc_normal_(p["ssm_in"], 1.0 / math.sqrt(d), gen)
    trunc_normal_(p["conv_w"], 0.1, gen)
    trunc_normal_(p["ssm_out"], 1.0 / math.sqrt(d_inner), gen)
    with torch.no_grad():
        p["conv_bias"].zero_()
        p["a_log"].copy_(torch.log(torch.linspace(1.0, 16.0, H)))
        p["dt_bias"].zero_()
        p["skip_d"].fill_(1.0)
        p["gnorm_scale"].fill_(1.0)


def _split_in(h: torch.Tensor, cfg: ModelConfig):
    d_inner, _, N, _ = dims(cfg)
    gN = cfg.ssm_ngroups * N
    return h[..., :d_inner], h[..., d_inner:2 * d_inner + 2 * gN], h[..., 2 * d_inner + 2 * gN:]


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with taps (W, C), then SiLU."""
    W, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = pad[:, 0:S, :] * w[0][None, None, :]
    for i in range(1, W):
        out = out + pad[:, i:i + S, :] * w[i][None, None, :]
    return F.silu(out + b[None, None, :].to(out.dtype))


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Mamba-2's gated RMSNorm before the out-projection."""
    y = y * F.silu(z)
    y32 = y.to(torch.float32)
    ms = torch.mean(torch.square(y32), dim=-1, keepdim=True)
    return (y32 * torch.rsqrt(ms + 1e-6) * scale).to(dtype)


def apply_mamba_block(p: dict[str, torch.Tensor], x: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence forward: x (B, S, D) -> (B, S, D)."""
    B, S, _ = x.shape
    d_inner, H, N, _ = dims(cfg)
    P = cfg.ssm_headdim
    h = x @ p["ssm_in"].to(x.dtype)
    z, xbc, dt = _split_in(h, cfg)
    xbc = _causal_conv(xbc, p["conv_w"].to(x.dtype), p["conv_bias"])
    gN = cfg.ssm_ngroups * N
    xs, bmat, cmat = xbc[..., :d_inner], xbc[..., d_inner:d_inner + gN], xbc[..., d_inner + gN:]
    xs = xs.reshape(B, S, H, P)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"][None, None, :])
    a = -torch.exp(p["a_log"])
    # ngroups == 1: B/C shared across heads
    y, _ = ops.ssd(xs.contiguous(), dt.contiguous(), a,
                   bmat.to(torch.float32).contiguous(), cmat.to(torch.float32).contiguous(),
                   p["skip_d"], chunk=cfg.ssm_chunk,
                   impl="xla" if cfg.attn_impl == "xla" else cfg.attn_impl)
    y = y.reshape(B, S, d_inner).to(x.dtype)
    return _gated_norm(y, z, p["gnorm_scale"], x.dtype) @ p["ssm_out"].to(x.dtype)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device, layers: int = 1) -> dict[str, torch.Tensor]:
    """The recurrent decode state of ``layers`` blocks: the conv window
    (layers, batch, W - 1, conv_dim) in ``dtype`` and the SSD state
    (layers, batch, H, N, P) in fp32, zero."""
    _, H, N, conv_dim = dims(cfg)
    return {
        "conv": torch.zeros((layers, batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((layers, batch, H, N, cfg.ssm_headdim), dtype=torch.float32,
                           device=device),
    }


def decode_mamba_block(p: dict[str, torch.Tensor], x: torch.Tensor,
                       conv_state: torch.Tensor, ssm_state: torch.Tensor,
                       cfg: ModelConfig):
    """One-token decode: x (B, 1, D), conv_state (B, W - 1, C), ssm_state
    (B, H, N, P); returns (out (B, 1, D), new conv state, new ssm state)."""
    B = x.shape[0]
    d_inner, H, N, _ = dims(cfg)
    P = cfg.ssm_headdim
    h = x[:, 0, :] @ p["ssm_in"].to(x.dtype)           # (B, in_dim)
    z, xbc, dt = _split_in(h, cfg)
    wdtype = torch.promote_types(conv_state.dtype, xbc.dtype)
    window = torch.cat([conv_state.to(wdtype), xbc[:, None, :].to(wdtype)], dim=1)
    # a bf16 conv_w widens exactly, as the reference's einsum promotes it
    conv = torch.einsum("bwc,wc->bc", window.to(torch.float32), p["conv_w"].to(torch.float32))
    xbc = F.silu(conv + p["conv_bias"]).to(x.dtype)
    gN = cfg.ssm_ngroups * N
    xs, bvec, cvec = xbc[..., :d_inner], xbc[..., d_inner:d_inner + gN], xbc[..., d_inner + gN:]
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"][None, :])
    a = -torch.exp(p["a_log"])
    y, new_ssm = ops.ssd_decode_step(
        ssm_state, xs.reshape(B, H, P).to(torch.float32), dt, a,
        bvec.to(torch.float32), cvec.to(torch.float32), p["skip_d"])
    y = y.reshape(B, d_inner).to(x.dtype)
    out = (_gated_norm(y, z, p["gnorm_scale"], x.dtype) @ p["ssm_out"].to(x.dtype))[:, None, :]
    return out, window[:, 1:, :], new_ssm
