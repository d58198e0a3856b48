"""The dense decoder of the paper's LLaMA configs (the dense path of the JAX
package's ``models/transformer.py``) as an ``nn.Module``.

Parameters are **layer-stacked** under the reference's paths, so the
optimizer sees the same leaves::

    blocks/attn/{wq, wk, wv, wo}   (L, d, H*hd) / (L, H*hd, d)
    blocks/ln1/norm_scale          (L, d)
    blocks/ln2/norm_scale          (L, d)
    blocks/mlp/{w_in, w_gate}      (L, d, d_ff)
    blocks/mlp/w_out               (L, d_ff, d)
    embed/embed                    (vocab, d)      tied with the unembedding
    final_norm/norm_scale          (d,)

GUM samples gamma of the L blocks of each stacked leaf, so one module per
layer would change what a block is.  ``forward`` loops over the layers.
There is no rematerialisation: autograd keeps each layer's activations.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import sort_paths
from repro_torch.launch.devices import resolve_device
from repro_torch.models.attention import self_attention
from repro_torch.models.layers import rms_norm, swiglu_mlp, trunc_normal_


def _group(**params: torch.Tensor) -> nn.Module:
    m = nn.Module()
    for name, t in params.items():
        m.register_parameter(name, nn.Parameter(t))
    return m


class Transformer(nn.Module):
    """Dense LLaMA-style decoder (RMSNorm, RoPE, SwiGLU, tied embeddings)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        """Allocate the parameters on ``device``, uninitialised: set them
        with :meth:`init_params` or :meth:`load_params` (``Trainer`` does
        one of the two)."""
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(f"model family {cfg.family!r} is not ported yet")
        if (cfg.act != "swiglu" or not cfg.tie_embeddings or cfg.norm != "rmsnorm"
                or cfg.qkv_bias or cfg.mlp_bias or cfg.frontend != "none"):
            raise NotImplementedError(f"{cfg.name}: only the dense SwiGLU/RMSNorm/"
                                      "tied-embedding decoder is ported")
        if cfg.dtype != "float32" or cfg.param_dtype != "float32":
            raise NotImplementedError("only fp32 parameters and activations are ported")
        if cfg.attn_impl != "xla":
            raise NotImplementedError(f"attn_impl={cfg.attn_impl!r} is not ported yet")
        self.cfg = cfg
        L, d, H, KV, hd, ff = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads,
                               cfg.hd, cfg.d_ff)

        def empty(*shape):
            return torch.empty(shape, dtype=torch.float32, device=device)

        self.embed = _group(embed=empty(cfg.vocab, d))
        self.blocks = nn.Module()
        self.blocks.attn = _group(wq=empty(L, d, H * hd), wk=empty(L, d, KV * hd),
                                  wv=empty(L, d, KV * hd), wo=empty(L, H * hd, d))
        self.blocks.ln1 = _group(norm_scale=empty(L, d))
        self.blocks.ln2 = _group(norm_scale=empty(L, d))
        self.blocks.mlp = _group(w_in=empty(L, d, ff), w_gate=empty(L, d, ff),
                                 w_out=empty(L, ff, d))
        self.final_norm = _group(norm_scale=empty(d))

    def init_params(self, seed: int) -> None:
        """Initialise every parameter from ``seed`` (a ``torch.Generator``
        on the parameters' device): truncated normals with the reference's
        scales, norms at one.  Not the reference's threefry draws: parity
        tests load the reference's parameters with :meth:`load_params`."""
        cfg = self.cfg
        gen = torch.Generator(device=self.embed.embed.device).manual_seed(seed)
        d, ff = cfg.d_model, cfg.d_ff
        attn, mlp = self.blocks.attn, self.blocks.mlp
        trunc_normal_(self.embed.embed, 0.02, gen)
        for w in (attn.wq, attn.wk, attn.wv, mlp.w_in, mlp.w_gate):
            trunc_normal_(w, d ** -0.5, gen)
        trunc_normal_(attn.wo, (cfg.n_heads * cfg.hd) ** -0.5, gen)
        trunc_normal_(mlp.w_out, ff ** -0.5, gen)
        with torch.no_grad():
            for norm in (self.blocks.ln1, self.blocks.ln2, self.final_norm):
                norm.norm_scale.fill_(1.0)

    def params(self) -> dict[str, nn.Parameter]:
        """``{path: parameter}`` in the reference's leaf order."""
        named = {name.replace(".", "/"): p for name, p in self.named_parameters()}
        return {k: named[k] for k in sort_paths(named)}

    def load_params(self, params: dict[str, torch.Tensor]) -> None:
        """Copy ``{path: tensor}`` (e.g. from :func:`repro_torch.convert.
        params_from_jax`) into the parameters; every path must match."""
        own = self.params()
        if set(params) != set(own):
            raise KeyError(f"parameter paths differ: missing {sorted(set(own) - set(params))}, "
                           f"unexpected {sorted(set(params) - set(own))}")
        with torch.no_grad():
            for k, p in own.items():
                if tuple(params[k].shape) != tuple(p.shape):
                    raise ValueError(f"{k}: shape {tuple(params[k].shape)} != {tuple(p.shape)}")
                p.copy_(params[k])

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) int -> logits (B, S, vocab), fp32."""
        cfg = self.cfg
        x = self.embed.embed[tokens]
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)[None, :]
        causal = cfg.causal and not cfg.encoder_only
        attn, mlp, b = self.blocks.attn, self.blocks.mlp, self.blocks
        for l in range(cfg.n_layers):
            h = rms_norm(x, b.ln1.norm_scale[l])
            x = x + self_attention(h, attn.wq[l], attn.wk[l], attn.wv[l], attn.wo[l],
                                   cfg, positions, causal)
            h = rms_norm(x, b.ln2.norm_scale[l])
            x = x + swiglu_mlp(h, mlp.w_in[l], mlp.w_gate[l], mlp.w_out[l])
        x = rms_norm(x, self.final_norm.norm_scale)
        return x @ self.embed.embed.T  # tied unembedding


def lm_loss(logits: torch.Tensor, targets: torch.Tensor, *, shift: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy."""
    if shift:
        logits, targets = logits[:, :-1], targets[:, 1:]
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def build_model(cfg: ModelConfig, *,
                device: Optional[str | torch.device] = None) -> Transformer:
    """The model for ``cfg`` on ``device`` (default: the CUDA device; raises
    when there is none — pass ``device="cpu"`` for the CPU), with its
    parameters allocated but not initialised (see :meth:`Transformer.
    init_params`)."""
    return Transformer(cfg, resolve_device(device))
