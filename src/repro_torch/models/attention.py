"""GQA self-attention and its one-token decode (the self-attention half of
the JAX package's ``models/attention.py``), on one layer's weights."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope


def _qkv(x: torch.Tensor, wq, wk, wv, cfg: ModelConfig):
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    q = (x @ wq.to(x.dtype)).reshape(x.shape[:-1] + (H, hd))
    k = (x @ wk.to(x.dtype)).reshape(x.shape[:-1] + (KV, hd))
    v = (x @ wv.to(x.dtype)).reshape(x.shape[:-1] + (KV, hd))
    return q, k, v


def self_attention(x: torch.Tensor, wq, wk, wv, wo, cfg: ModelConfig,
                   positions: torch.Tensor, causal: bool):
    """Full-sequence attention of x (B, S, D) through ``ops.attention`` at
    ``cfg.attn_impl``; returns the output and the fresh (k, v), each
    (B, S, KV, hd) after RoPE."""
    q, k, v = _qkv(x, wq, wk, wv, cfg)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    o = ops.attention(q, k, v, causal=causal, impl=cfg.attn_impl)
    return o.reshape(x.shape[:-1] + (cfg.n_heads * cfg.hd,)) @ wo.to(x.dtype), (k, v)


def decode_self_attention(x: torch.Tensor, wq, wk, wv, wo, cfg: ModelConfig,
                          kcache: torch.Tensor, vcache: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
    """One-token decode: x (B, 1, D), caches (B, Smax, KV, hd), pos (B,) —
    each row at its own position.  Writes the new k and v into row b of the
    caches at ``pos[b]`` **in place** (the reference returns updated copies)
    and attends over positions 0..pos[b]."""
    q, k, v = _qkv(x, wq, wk, wv, cfg)
    q = apply_rope(q, pos[:, None], cfg)
    k = apply_rope(k, pos[:, None], cfg)
    rows = torch.arange(x.shape[0], device=x.device)
    kcache[rows, pos] = k[:, 0].to(kcache.dtype)
    vcache[rows, pos] = v[:, 0].to(vcache.dtype)
    o = ops.decode_attention(q, kcache, vcache, pos)
    return o.reshape(x.shape[:-1] + (cfg.n_heads * cfg.hd,)) @ wo.to(x.dtype)
