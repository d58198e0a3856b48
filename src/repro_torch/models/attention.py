"""GQA self-attention, its one-token decode and cross-attention (the JAX
package's ``models/attention.py``), on one layer's weights ``p``: ``wq``,
``wk``, ``wv``, ``wo`` and, under ``cfg.qkv_bias``, ``bias_q``, ``bias_k``,
``bias_v`` (self-attention only: cross-attention reads no bias, as in the
reference), each cast to the activations' dtype at its use.

On a model axis (:mod:`repro_torch.models.tensor_parallel`) self-attention
computes this rank's ``H / T`` contiguous q heads and the kv heads they
read, and sums its ``wo`` partial products over the axis."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import tensor_parallel
from repro_torch.models.layers import apply_rope


def _qkv(x: torch.Tensor, p: dict[str, torch.Tensor], cfg: ModelConfig):
    """q, k, v of ``x``, each (B, S, heads, hd).  On a model axis of size T:
    this rank's q heads ``[r·H/T, (r+1)·H/T)`` from ``wq``'s part, and the kv
    heads they read, from ``wk`` / ``wv``'s parts where ``KV % T == 0``, else
    from the whole ``wk`` / ``wv`` (gathered over ``model`` where a rule
    splits them) with the heads this rank's q heads read picked out."""
    tp = tensor_parallel.active()
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    T = 1 if tp is None else tp.tp
    wk, wv = p["wk"], p["wv"]
    if tp is not None:
        tensor_parallel.check_heads(cfg, T)
        x = tensor_parallel.enter(tp, x)
        if KV % T and wk.shape[-1] != KV * hd:
            wk = tensor_parallel.gather_model(tp, wk, -1)
            wv = tensor_parallel.gather_model(tp, wv, -1)
    hq, kv = H // T, (KV if KV % T else KV // T)
    q = x @ p["wq"].to(x.dtype)
    k = x @ wk.to(x.dtype)
    v = x @ wv.to(x.dtype)
    if "bias_q" in p:
        q = q + tensor_parallel.local(tp, p["bias_q"], hq * hd).to(x.dtype)
        k = k + tensor_parallel.local(tp, p["bias_k"], kv * hd).to(x.dtype)
        v = v + tensor_parallel.local(tp, p["bias_v"], kv * hd).to(x.dtype)
    q = q.reshape(x.shape[:-1] + (hq, hd))
    k = k.reshape(x.shape[:-1] + (kv, hd))
    v = v.reshape(x.shape[:-1] + (kv, hd))
    if KV % T:
        group = H // KV
        a, b = tensor_parallel.span(tp, H)
        read = [h // group for h in range(a, b)]
        heads = sorted(set(read))
        if hq % len(heads) or read != [h for h in heads for _ in range(hq // len(heads))]:
            heads = read  # one kv head a q head
        k, v = k[..., heads, :], v[..., heads, :]
    return q, k, v


def self_attention(x: torch.Tensor, p: dict[str, torch.Tensor], cfg: ModelConfig,
                   positions: torch.Tensor, causal: bool):
    """Full-sequence attention of x (B, S, D) through ``ops.attention`` at
    ``cfg.attn_impl``; returns the output and the fresh (k, v), each
    (B, S, KV, hd) after RoPE.  On a model axis: this rank's heads, and the
    output summed over the axis (its k, v are the rank's kv heads)."""
    q, k, v = _qkv(x, p, cfg)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    o = ops.attention(q, k, v, causal=causal, impl=cfg.attn_impl)
    out = o.reshape(x.shape[:-1] + (q.shape[-2] * cfg.hd,)) @ p["wo"].to(x.dtype)
    tp = tensor_parallel.active()
    return (out if tp is None else tensor_parallel.leave(tp, out)), (k, v)


def decode_self_attention(x: torch.Tensor, p: dict[str, torch.Tensor], cfg: ModelConfig,
                          kcache: torch.Tensor, vcache: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
    """One-token decode: x (B, 1, D), caches (B, Smax, KV, hd), pos (B,) —
    each row at its own position.  Writes the new k and v into row b of the
    caches at ``pos[b]`` **in place** (the reference returns updated copies)
    and attends over positions 0..pos[b]."""
    q, k, v = _qkv(x, p, cfg)
    q = apply_rope(q, pos[:, None], cfg)
    k = apply_rope(k, pos[:, None], cfg)
    rows = torch.arange(x.shape[0], device=x.device)
    kcache[rows, pos] = k[:, 0].to(kcache.dtype)
    vcache[rows, pos] = v[:, 0].to(vcache.dtype)
    o = ops.decode_attention(q, kcache, vcache, pos)
    return o.reshape(x.shape[:-1] + (cfg.n_heads * cfg.hd,)) @ p["wo"].to(x.dtype)


def cross_attention(x: torch.Tensor, p: dict[str, torch.Tensor], cfg: ModelConfig,
                    xk: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) attends over precomputed image K/V (B, T_img, KV, hd),
    no RoPE and no mask (Llama-3.2-Vision): ``ops.attention`` with
    ``causal=False`` at ``cfg.attn_impl``, so S != T (and S = 1 in decode)."""
    H, hd = cfg.n_heads, cfg.hd
    q = (x @ p["wq"].to(x.dtype)).reshape(x.shape[:-1] + (H, hd))
    o = ops.attention(q, xk.to(x.dtype), xv.to(x.dtype), causal=False, impl=cfg.attn_impl)
    return o.reshape(x.shape[:-1] + (H * hd,)) @ p["wo"].to(x.dtype)


def encode_cross_kv(p: dict[str, torch.Tensor], img: torch.Tensor, cfg: ModelConfig):
    """The K/V projections of the image embeddings img (B, T_img, D), each
    (B, T_img, KV, hd) in img's dtype."""
    KV, hd = cfg.kv_heads, cfg.hd
    k = (img @ p["wk"].to(img.dtype)).reshape(img.shape[:-1] + (KV, hd))
    v = (img @ p["wv"].to(img.dtype)).reshape(img.shape[:-1] + (KV, hd))
    return k, v
