"""GQA self-attention (the self-attention half of the JAX package's
``models/attention.py``), on layer-stacked weights."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import attention_ref
from repro_torch.models.layers import apply_rope


def self_attention(x: torch.Tensor, wq, wk, wv, wo, cfg: ModelConfig,
                   positions: torch.Tensor, causal: bool) -> torch.Tensor:
    """Full-sequence attention of x (B, S, D) with one layer's weights."""
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    q = (x @ wq).reshape(x.shape[:-1] + (H, hd))
    k = (x @ wk).reshape(x.shape[:-1] + (KV, hd))
    v = (x @ wv).reshape(x.shape[:-1] + (KV, hd))
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    o = attention_ref(q, k, v, causal=causal)
    return o.reshape(x.shape[:-1] + (H * hd,)) @ wo
