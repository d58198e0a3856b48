"""Model assembly for every family of the JAX package's
``models/transformer.py``, each an ``nn.Module``: the dense decoder (the
paper's LLaMA and the dense variants: chatglm3-6b, qwen1.5-4b,
starcoder2-7b, nemotron-4-340b) and the audio encoder (hubert-xlarge) in
:class:`Transformer`, the Mamba-2 (ssm) model, the hybrid (zamba2-1.2b),
the moe family (dbrx-132b, llama4-maverick-400b) and the vlm
(llama-3.2-vision-11b).

Parameters are **layer-stacked** under the reference's paths, so the
optimizer sees the same leaves.  Dense::

    blocks/attn/{wq, wk, wv, wo}   (L, d, H*hd) / (L, H*hd, d)
    blocks/attn/bias_q             (L, H*hd)       under qkv_bias
    blocks/attn/{bias_k, bias_v}   (L, KV*hd)      under qkv_bias
    blocks/ln{1,2}/norm_scale      (L, d)
    blocks/ln{1,2}/norm_bias       (L, d)          layernorm only
    blocks/mlp/{w_in, w_gate}      (L, d, d_ff)    w_gate for swiglu / geglu
    blocks/mlp/w_out               (L, d_ff, d)
    blocks/mlp/bias_in             (L, d_ff)       under mlp_bias
    blocks/mlp/bias_out            (L, d)          under mlp_bias
    embed/embed                    (vocab, d)      tied unless embed/lm_head
    embed/lm_head                  (d, vocab)      only when not tied
    final_norm/norm_scale          (d,)
    final_norm/norm_bias           (d,)            layernorm only

audio (``frontend="frames"``): the dense blocks, encoder-only (no mask, no
decode), and the frames front end in place of the token embedding::

    embed/frame_proj               (d, d)          frames (B, S, d) @ it
    embed/pos_embed                (max_seq, d)    learned positions, added
    embed/lm_head                  (d, vocab)

ssm (Mamba-2)::

    blocks/ln1/norm_scale          (L, d)
    blocks/mamba/{a_log, conv_bias, conv_w, dt_bias, gnorm_scale, skip_d,
                  ssm_in, ssm_out} (L, ...)   see models/mamba2.py
    embed/{embed, lm_head}
    final_norm/norm_scale          (d,)

hybrid (zamba2-1.2b): the ssm tree and one dense block, **not** stacked,
applied after Mamba layer l when ``l % shared_attn_every == 0``::

    shared/{attn, ln1, ln2, mlp}/...   as one layer of the dense tree

moe, ``moe_every == 1`` (dbrx-132b): the dense tree's ``blocks/{attn, ln1,
ln2}`` with ``blocks/moe`` in place of ``blocks/mlp``::

    blocks/moe/router              (L, d, E)
    blocks/moe/experts_{w_in, w_gate}  (L, E, d, f)   f = moe_dff
    blocks/moe/experts_w_out       (L, E, f, d)
    blocks/moe/shared_{w_in, w_gate}   (L, d, f * n_shared)   with shared experts
    blocks/moe/shared_w_out        (L, f * n_shared, d)

moe, ``moe_every > 1`` (llama4-maverick-400b): G = L / moe_every groups,
each ``per = moe_every - 1`` dense blocks and one MoE block::

    blocks/dense/{attn, ln1, ln2, mlp}/...   (G, per, ...)  as the dense tree
    blocks/moe/{attn, ln1, ln2}/...          (G, ...)
    blocks/moe/moe/...                       (G, ...)       as above

vlm (llama-3.2-vision-11b): G = L / cross_attn_every groups, each ``per =
cross_attn_every`` dense blocks and one gated cross-attention block, whose
K/V come from the images (B, n_image_tokens, d)::

    blocks/self/{attn, ln1, ln2, mlp}/...    (G, per, ...)  as the dense tree
    blocks/cross/{ln, ln_mlp}/...            (G, d)
    blocks/cross/xattn/{wq, wk, wv, wo}      (G, ...)       as attn
    blocks/cross/mlp/...                     (G, ...)       as the dense mlp
    blocks/cross/{gate_attn, gate_mlp}       (G,)           zero at init

GUM samples gamma of the L blocks of each stacked leaf, so one module per
layer would change what a block is.  ``forward`` loops over the layers.
Under ``cfg.remat``, when autograd records, each layer (or group) runs under
``torch.utils.checkpoint`` (the reference's per-layer ``jax.checkpoint``):
``remat_policy="dots"`` keeps the un-batched products, any other policy
keeps nothing, and backward recomputes the rest.
Parameters are fp32, or, under ``cfg.param_dtype="bfloat16"``, stored as
the reference stores them: every leaf with two or more dims in bf16 (the
layer-stacked norms, biases and Mamba vectors and the router included), the
``(d,)`` leaves of ``final_norm``, of the hybrid's shared norms and the vlm
gates in fp32.  All families
compute in ``cfg.dtype`` (bf16 for every full-size config but the paper's
LLaMA), casting each weight at its use, as the reference does (a no-op on a
bf16 leaf in bf16, an up-cast when a bf16-stored model runs in fp32).

The moe family's ``forward(return_aux=True)`` also returns the MoE layers'
summed load-balancing loss, which :func:`lm_loss` and
:func:`chunked_lm_loss` add at 0.01.  The audio family's forward takes
``frames=`` in place of tokens, the vlm's ``images=`` beside them.

Serving: ``forward(tokens, return_cache=True)`` (prefill), ``init_cache``,
``decode_step(cache, tokens, pos)`` with one position per batch row, and
``reset_slot`` (zero one row's recurrent state).  ``decode_step`` updates
the cache **in place** and returns it; the reference returns a new one.
The audio family is encoder-only: ``init_cache`` and ``decode_step`` raise.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import sort_paths
from repro_torch.kernels import ops
from repro_torch.launch.devices import resolve_device
from repro_torch.models import mamba2, moe, tensor_parallel
from repro_torch.models.attention import (
    cross_attention,
    decode_self_attention,
    encode_cross_kv,
    self_attention,
)
from repro_torch.models.layers import apply_mlp, apply_norm, trunc_normal_, unembed
from repro_torch.sharding import active_param_split


def _group(**params: torch.Tensor) -> nn.Module:
    m = nn.Module()
    for name, t in params.items():
        m.register_parameter(name, nn.Parameter(t))
    return m


class _CastGather(torch.autograd.Function):
    """``table.to(dtype)[tokens]`` without a cast copy of the whole table:
    the rows are gathered, then cast.  Backward sums each row's gradients in
    the wider of ``dtype`` and the table's dtype and rounds the sum once into
    the table's, as the reference's cast-then-gather does on a bf16 table in
    fp32 (autograd's gather-then-cast would round every row's gradient to
    bf16 before summing them in bf16); otherwise it is autograd's own."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype):
        ctx.save_for_backward(tokens)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return table[tokens].to(dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (tokens,) = ctx.saved_tensors
        wide = torch.promote_types(g.dtype, ctx.table_dtype)
        total = g.new_zeros(ctx.table_shape, dtype=wide)
        total.index_put_((tokens,), g.to(wide), accumulate=True)
        return total.to(ctx.table_dtype), None, None


def _at_groups(groups: dict[str, nn.Module], l=None) -> dict[str, dict[str, torch.Tensor]]:
    """Each group's parameters by name: layer ``l`` of each stack (an int, or
    a (group, j) pair over two stack dims), or the tensors themselves (``l``
    None).  Under parameter sharding (:class:`repro_torch.sharding.ParamSplit`)
    the split stacks' slices of layer ``l`` come whole from ONE all-gather
    over all the groups."""
    split = active_param_split()
    if split is not None and l is not None:
        return split.layer_params(groups, l)
    return {name: {k: p if l is None else p[l] for k, p in group.named_parameters()}
            for name, group in groups.items()}


def _at(group: nn.Module, l=None) -> dict[str, torch.Tensor]:
    """A group's parameters by name (see :func:`_at_groups`)."""
    return _at_groups({"": group}, l)[""]


# The products without batch dimensions, which remat_policy="dots" keeps (the
# reference's jax.checkpoint_policies.dots_with_no_batch_dims_saveable): the
# layers' x @ w reach aten.mm; attention's batched q kᵀ and p v (aten.bmm)
# are recomputed.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` (one layer's body) under ``torch.utils.checkpoint`` when
    ``cfg.remat`` is set and autograd records, as the reference's ``_remat``
    wraps it in ``jax.checkpoint``: ``"dots"`` saves the outputs of the
    un-batched products, any other policy saves nothing."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    if cfg.remat_policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=context_fn)
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _positions(pos, batch: int, device: torch.device) -> torch.Tensor:
    """A scalar or (B,) decode position as a (B,) int64 tensor on ``device``."""
    pos = torch.as_tensor(pos, device=device, dtype=torch.int64)
    return pos.expand(batch) if pos.dim() == 0 else pos


class _LM(nn.Module):
    """What every family shares: parameter paths, loading, the embedding,
    the dense block and the head."""

    cfg: ModelConfig

    def _empty(self, *shape) -> torch.Tensor:
        """An uninitialised leaf as the reference stores it: in
        ``cfg.param_dtype`` with two or more dims, else fp32."""
        dtype = getattr(torch, self.cfg.param_dtype) if len(shape) >= 2 else torch.float32
        return torch.empty(shape, dtype=dtype, device=self._device)

    def _init_embed(self, gen: torch.Generator) -> None:
        if self.cfg.frontend == "frames":
            trunc_normal_(self.embed.frame_proj, self.cfg.d_model ** -0.5, gen)
            trunc_normal_(self.embed.pos_embed, 0.02, gen)
            trunc_normal_(self.embed.lm_head, 0.02, gen)
            return
        trunc_normal_(self.embed.embed, 0.02, gen)
        if not self.cfg.tie_embeddings:
            trunc_normal_(self.embed.lm_head, 0.02, gen)

    @property
    def device(self) -> torch.device:
        """The parameters' device."""
        return self.final_norm.norm_scale.device

    @property
    def dtype(self) -> torch.dtype:
        """The activation dtype (``cfg.dtype``)."""
        return getattr(torch, self.cfg.dtype)

    def params(self) -> dict[str, nn.Parameter]:
        """``{path: parameter}`` in the reference's leaf order."""
        named = {name.replace(".", "/"): p for name, p in self.named_parameters()}
        return {k: named[k] for k in sort_paths(named)}

    def load_params(self, params: dict[str, torch.Tensor]) -> None:
        """Copy ``{path: tensor}`` (e.g. from :func:`repro_torch.convert.
        params_from_jax`) into the parameters; every path must match.  Each
        parameter keeps its dtype: a tensor of another dtype is cast to it."""
        own = self.params()
        if set(params) != set(own):
            raise KeyError(f"parameter paths differ: missing {sorted(set(own) - set(params))}, "
                           f"unexpected {sorted(set(params) - set(own))}")
        with torch.no_grad():
            for k, p in own.items():
                if tuple(params[k].shape) != tuple(p.shape):
                    raise ValueError(f"{k}: shape {tuple(params[k].shape)} != {tuple(p.shape)}")
                p.copy_(params[k])

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        tp = tensor_parallel.active()
        if tp is not None:  # this rank's vocab rows, summed over the model axis
            return tensor_parallel.vocab_embed(tp, self.embed.embed, tokens, self.dtype)
        return _CastGather.apply(self.embed.embed, tokens, self.dtype)

    def _final(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(x, _at(self.final_norm), self.cfg)

    def _norm_group(self, *lead: int) -> nn.Module:
        """A norm's parameters, allocated: ``norm_scale`` (lead + (d,)) and,
        under layernorm, ``norm_bias``."""
        d = self.cfg.d_model
        bias = {"norm_bias": self._empty(*lead, d)} if self.cfg.norm == "layernorm" else {}
        return _group(norm_scale=self._empty(*lead, d), **bias)

    def _attn_group(self, *lead: int) -> nn.Module:
        """One attention's parameters, allocated: ``wq``, ``wk``, ``wv``,
        ``wo`` (lead + matrix) and, under ``qkv_bias``, the biases."""
        cfg, empty = self.cfg, self._empty
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd
        bias = ({"bias_q": empty(*lead, H * hd), "bias_k": empty(*lead, KV * hd),
                 "bias_v": empty(*lead, KV * hd)} if cfg.qkv_bias else {})
        return _group(wq=empty(*lead, d, H * hd), wk=empty(*lead, d, KV * hd),
                      wv=empty(*lead, d, KV * hd), wo=empty(*lead, H * hd, d), **bias)

    def _mlp_group(self, *lead: int) -> nn.Module:
        """One MLP's parameters, allocated: ``w_in``, ``w_gate`` (gated acts),
        ``w_out`` and, under ``mlp_bias``, the biases."""
        cfg, empty = self.cfg, self._empty
        d, ff = cfg.d_model, cfg.d_ff
        gate = {"w_gate": empty(*lead, d, ff)} if cfg.act in ("swiglu", "geglu") else {}
        bias = {"bias_in": empty(*lead, ff), "bias_out": empty(*lead, d)} if cfg.mlp_bias else {}
        return _group(w_in=empty(*lead, d, ff), **gate, w_out=empty(*lead, ff, d), **bias)

    def _check_dense_parts(self, cfg: ModelConfig, frontends=("none",)) -> None:
        """Raise for what the attention / MLP blocks do not port."""
        if (cfg.act not in Transformer.ACTS or cfg.norm not in ("rmsnorm", "layernorm")
                or cfg.rope not in ("rope", "rope2d", "none") or cfg.frontend not in frontends):
            raise NotImplementedError(f"{cfg.name}: act {cfg.act!r}, norm {cfg.norm!r}, rope "
                                      f"{cfg.rope!r}, frontend {cfg.frontend!r} is not ported")
        self._check_dtypes(cfg)

    @staticmethod
    def _check_dtypes(cfg: ModelConfig) -> None:
        """Raise for a storage or activation dtype not ported, and an
        unknown attention route."""
        if cfg.dtype not in ("float32", "bfloat16") or cfg.param_dtype not in ("float32",
                                                                              "bfloat16"):
            raise NotImplementedError(f"the {cfg.family} family takes fp32 or bf16 parameters "
                                      "and fp32 or bf16 activations (fp16 storage: ROADMAP "
                                      "queue 1 item 2i)")
        ops.check_impl(cfg.attn_impl)

    def _init_norms(self, *groups: nn.Module) -> None:
        with torch.no_grad():
            for norm in groups:
                norm.norm_scale.fill_(1.0)
                if hasattr(norm, "norm_bias"):
                    norm.norm_bias.zero_()

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return unembed(self._final(x), getattr(self.embed, "embed", None),
                       getattr(self.embed, "lm_head", None))

    def _init_dense_parts(self, gen: torch.Generator, attns=(), mlps=()) -> None:
        """Initialise attention and MLP groups (any lead dims) from ``gen``:
        truncated normals at the reference's scales, biases zero."""
        cfg = self.cfg
        for attn in attns:
            for w in (attn.wq, attn.wk, attn.wv):
                trunc_normal_(w, cfg.d_model ** -0.5, gen)
            trunc_normal_(attn.wo, (cfg.n_heads * cfg.hd) ** -0.5, gen)
        for mlp in mlps:
            for w in (mlp.w_in, getattr(mlp, "w_gate", None)):
                if w is not None:
                    trunc_normal_(w, cfg.d_model ** -0.5, gen)
            trunc_normal_(mlp.w_out, cfg.d_ff ** -0.5, gen)
        with torch.no_grad():
            for group in (*attns, *mlps):
                for name, p in group.named_parameters():
                    if name.startswith("bias_"):
                        p.zero_()

    @staticmethod
    def _block(blocks: nn.Module, i) -> dict[str, dict[str, torch.Tensor]]:
        """Block ``i`` (an int, a (group, j) pair, or None for an unstacked
        block) of ``blocks``' stacks."""
        return _at_groups(dict(blocks.named_children()), i)

    def stack_dims(self, path: str) -> int:
        """How many leading dims of the leaf at ``path`` index its layers
        (the dims the layer loop selects): one under ``blocks/``, none
        elsewhere."""
        return 1 if path.startswith("blocks/") else 0

    def _attend(self, x, p, positions, causal):
        h, (k, v) = self_attention(apply_norm(x, p["ln1"], self.cfg), p["attn"], self.cfg,
                                   positions, causal)
        return x + h, k, v

    def _dense_block(self, x, p, positions, causal):
        x, k, v = self._attend(x, p, positions, causal)
        return x + apply_mlp(apply_norm(x, p["ln2"], self.cfg), p["mlp"], self.cfg.act), k, v

    def _decode_dense_block(self, x, p, kc, vc, pos):
        """One token of a dense block over its KV cache rows (in place)."""
        cfg = self.cfg
        x = x + decode_self_attention(apply_norm(x, p["ln1"], cfg), p["attn"], cfg, kc, vc, pos)
        return x + apply_mlp(apply_norm(x, p["ln2"], cfg), p["mlp"], cfg.act)


class Transformer(_LM):
    """Dense decoder: pre-norm blocks of GQA self-attention and an MLP, tied
    or untied head.  ``act`` swiglu / geglu / gelu / relu2, ``norm``
    rmsnorm / layernorm, ``qkv_bias``, ``mlp_bias``, ``rope`` rope (any
    ``rope_fraction``) / rope2d / none; fp32 or bf16 parameters
    (``param_dtype``), activations in ``cfg.dtype`` (fp32 or bf16).  The
    audio family (hubert-xlarge) is the same blocks behind the frames front
    end (``frontend="frames"``), unmasked under ``encoder_only``, with no
    decode."""

    ACTS = ("swiglu", "geglu", "gelu", "relu2")

    def __init__(self, cfg: ModelConfig, device: torch.device):
        """Allocate the parameters on ``device``, uninitialised: set them
        with :meth:`init_params` or :meth:`load_params` (``Trainer`` does
        one of the two)."""
        super().__init__()
        if cfg.family not in ("dense", "audio"):
            raise NotImplementedError(f"model family {cfg.family!r} is not a dense or audio "
                                      "model")
        self._check_dense_parts(cfg, frontends=("none", "frames"))
        self.cfg, self._device = cfg, device
        L, d = cfg.n_layers, cfg.d_model
        if cfg.frontend == "frames":
            self.embed = _group(frame_proj=self._empty(d, d), pos_embed=self._empty(cfg.max_seq, d),
                                lm_head=self._empty(d, cfg.vocab))
        else:
            head = {} if cfg.tie_embeddings else {"lm_head": self._empty(d, cfg.vocab)}
            self.embed = _group(embed=self._empty(cfg.vocab, d), **head)
        self.blocks = nn.Module()
        self.blocks.attn = self._attn_group(L)
        self.blocks.ln1 = self._norm_group(L)
        self.blocks.ln2 = self._norm_group(L)
        self.blocks.mlp = self._mlp_group(L)
        self.final_norm = self._norm_group()

    def init_params(self, seed: int) -> None:
        """Initialise every parameter from ``seed`` (a ``torch.Generator``
        on the parameters' device): truncated normals with the reference's
        scales, drawn in fp32 and cast to a bf16 leaf (:func:`trunc_normal_`),
        norms at one, biases at zero.  Not the reference's threefry draws:
        parity tests load the reference's parameters with
        :meth:`load_params`."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        d, ff = cfg.d_model, cfg.d_ff
        attn, mlp = self.blocks.attn, self.blocks.mlp
        self._init_embed(gen)
        for w in (attn.wq, attn.wk, attn.wv, mlp.w_in, getattr(mlp, "w_gate", None)):
            if w is not None:
                trunc_normal_(w, d ** -0.5, gen)
        trunc_normal_(attn.wo, (cfg.n_heads * cfg.hd) ** -0.5, gen)
        trunc_normal_(mlp.w_out, ff ** -0.5, gen)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.split(".")[-1].startswith("bias_"):
                    p.zero_()
        self._init_norms(self.blocks.ln1, self.blocks.ln2, self.final_norm)

    def _layer(self, l: int) -> dict[str, dict[str, torch.Tensor]]:
        """Layer ``l``'s parameters: {"attn", "ln1", "ln2", "mlp": {name: tensor}}."""
        b = self.blocks
        return _at_groups({"attn": b.attn, "ln1": b.ln1, "ln2": b.ln2, "mlp": b.mlp}, l)

    def _input(self, tokens: Optional[torch.Tensor],
               frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The first layer's input in the activation dtype: the token
        embedding, or under the frames front end ``frames @ frame_proj``
        plus the learned positions (the reference's ``_embed_input``)."""
        if self.cfg.frontend != "frames":
            return self._embed(tokens)
        if frames is None:
            raise ValueError(f"{self.cfg.name} takes frames (B, S, d_model), not tokens")
        dtype = self.dtype
        x = frames.to(dtype) @ self.embed.frame_proj.to(dtype)
        return x + self.embed.pos_embed[:x.shape[1]].to(dtype)[None]

    def _require_decode(self) -> None:
        if not self.cfg.has_decode:
            raise ValueError(f"{self.cfg.name} ({self.cfg.family}) is encoder-only: it has "
                             "no decode cache, decode step or engine")

    def forward(self, tokens: Optional[torch.Tensor] = None, return_cache: bool = False,
                return_hidden: bool = False, *, frames: Optional[torch.Tensor] = None):
        """tokens (B, S) int (or, audio, ``frames`` (B, S, d)) -> logits
        (B, S, vocab) in the activation dtype; with ``return_cache`` ->
        (logits, {"k", "v": (L, B, S, KV, hd)}); with ``return_hidden`` the
        final-normed hidden states (B, S, d) in place of the logits
        (:func:`chunked_lm_loss` unembeds them)."""
        cfg = self.cfg
        x = self._input(tokens, frames)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)[None, :]
        causal = cfg.causal and not cfg.encoder_only

        def layer(x: torch.Tensor, l: int):
            return self._dense_block(x, self._layer(l), positions, causal)

        layer = _remat(layer, cfg)
        ks, vs = [], []
        for l in range(cfg.n_layers):
            x, k, v = layer(x, l)
            if return_cache:
                ks.append(k)
                vs.append(v)
        logits = self._final(x) if return_hidden else self._head(x)
        if return_cache:
            return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}
        return logits

    def init_cache(self, batch: int, max_seq: int,
                   dtype: Optional[torch.dtype] = None) -> dict[str, torch.Tensor]:
        """Zero KV cache {"k", "v": (L, batch, max_seq, KV, hd)} on the
        model's device, in ``dtype`` (default the activation dtype)."""
        self._require_decode()
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_seq, cfg.kv_heads, cfg.hd)
        dtype = dtype or self.dtype
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    def decode_step(self, cache: dict, tokens: torch.Tensor, pos):
        """One token per row: tokens (B, 1), pos an int or (B,) -> (logits
        (B, 1, vocab), cache), row b at position pos[b]."""
        self._require_decode()
        pos = _positions(pos, tokens.shape[0], tokens.device)
        x = self._embed(tokens)
        for l in range(self.cfg.n_layers):
            x = self._decode_dense_block(x, self._layer(l), cache["k"][l], cache["v"][l], pos)
        return self._head(x), cache

    def reset_slot(self, cache: dict, slot: int) -> None:
        """Nothing to reset: a row's KV entries past its position are masked
        (kv_len = pos + 1) and rewritten before they are read."""


class _MambaStack(_LM):
    """The Mamba-2 layer stack that the ssm and hybrid families share:
    pre-norm Mamba blocks, the embedding, the final norm, their init, one
    layer's forward and decode, and the recurrent decode state."""

    def _build_stack(self, cfg: ModelConfig, device: torch.device) -> None:
        if cfg.ssm_ngroups != 1 or cfg.norm != "rmsnorm" or cfg.frontend != "none":
            raise NotImplementedError(f"{cfg.name}: only ngroups=1 with RMSNorm and a "
                                      "token embedding is ported")
        self._check_dtypes(cfg)
        self.cfg, self._device = cfg, device
        L, d = cfg.n_layers, cfg.d_model
        empty = self._empty
        head = {} if cfg.tie_embeddings else {"lm_head": empty(d, cfg.vocab)}
        self.embed = _group(embed=empty(cfg.vocab, d), **head)
        self.blocks = nn.Module()
        self.blocks.ln1 = self._norm_group(L)
        self.blocks.mamba = _group(**{name: empty(L, *shape) for name, shape
                                      in mamba2.param_shapes(cfg).items()})
        self.final_norm = self._norm_group()

    def init_params(self, seed: int) -> None:
        """Initialise from ``seed``: the reference's distributions and
        constants, not its draws (see :meth:`Transformer.init_params`)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self._init_embed(gen)
        mamba2.init_mamba_block(self._layer(None), self.cfg, gen)
        self._init_norms(self.blocks.ln1, self.final_norm)

    def _layer(self, l: Optional[int]) -> dict[str, torch.Tensor]:
        """Layer ``l``'s block parameters by name (None: the whole stacks)."""
        return _at(self.blocks.mamba, l)

    def _mamba_layer(self, x: torch.Tensor, l: int) -> torch.Tensor:
        h = apply_norm(x, _at(self.blocks.ln1, l), self.cfg)
        return x + mamba2.apply_mamba_block(self._layer(l), h, self.cfg)

    def _decode_mamba(self, x: torch.Tensor, l: int, cache: dict) -> torch.Tensor:
        """One token of Mamba layer ``l`` over its state in ``cache`` (the
        {"conv", "ssm"} stacks, updated in place)."""
        h = apply_norm(x, _at(self.blocks.ln1, l), self.cfg)
        o, conv, ssm = mamba2.decode_mamba_block(self._layer(l), h, cache["conv"][l],
                                                 cache["ssm"][l], self.cfg)
        cache["conv"][l] = conv
        cache["ssm"][l] = ssm
        return x + o

    def _mamba_cache(self, batch: int, dtype: Optional[torch.dtype]) -> dict:
        """Zero recurrent state {"conv": (L, batch, W - 1, conv_dim) in
        ``dtype`` (default the activation dtype), "ssm": (L, batch, H, N, P)
        fp32}."""
        return mamba2.init_mamba_cache(self.cfg, batch, dtype or self.dtype, self.device,
                                       layers=self.cfg.n_layers)

    @staticmethod
    def _reset_mamba(cache: dict, slot: int) -> None:
        """Zero row ``slot`` of the conv window and the SSD state, so a new
        request there starts from the empty state."""
        cache["conv"][:, slot] = 0
        cache["ssm"][:, slot] = 0


class Mamba2(_MambaStack):
    """Attention-free Mamba-2 (SSD) model: pre-norm Mamba blocks, untied or
    tied head; parameters in fp32 or stored in ``cfg.param_dtype`` (bf16),
    activations in ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        if cfg.family != "ssm":
            raise NotImplementedError(f"model family {cfg.family!r} is not an ssm model")
        self._build_stack(cfg, device)

    def forward(self, tokens: torch.Tensor, return_cache: bool = False,
                return_hidden: bool = False):
        """tokens (B, S) -> logits (B, S, vocab) in the activation dtype;
        with ``return_cache`` -> (logits, None): as in the reference, the
        ssm prefill builds no decode cache; with ``return_hidden`` the
        final-normed hidden states in place of the logits."""
        layer = _remat(self._mamba_layer, self.cfg)
        x = self._embed(tokens)
        for l in range(self.cfg.n_layers):
            x = layer(x, l)
        logits = self._final(x) if return_hidden else self._head(x)
        return (logits, None) if return_cache else logits

    def init_cache(self, batch: int, max_seq: int,
                   dtype: Optional[torch.dtype] = None) -> dict[str, torch.Tensor]:
        """Zero recurrent state (:meth:`_mamba_cache`); ``max_seq`` does not
        bound it."""
        del max_seq
        return self._mamba_cache(batch, dtype)

    def decode_step(self, cache: dict, tokens: torch.Tensor, pos):
        """One token per row: tokens (B, 1) -> (logits (B, 1, vocab), cache).
        The state carries the position, so ``pos`` is not read."""
        del pos
        x = self._embed(tokens)
        for l in range(self.cfg.n_layers):
            x = self._decode_mamba(x, l, cache)
        return self._head(x), cache

    def reset_slot(self, cache: dict, slot: int) -> None:
        """Zero row ``slot``'s state (:meth:`_reset_mamba`)."""
        self._reset_mamba(cache, slot)


class Hybrid(_MambaStack):
    """The hybrid family (zamba2-1.2b, Zamba-2): the Mamba-2 model's layer
    stack plus one shared dense block (GQA self-attention and an MLP, one
    copy, not stacked) run after Mamba layer l when ``l %
    shared_attn_every == 0``.  As in the reference, the prefill builds no
    decode cache; the decode cache holds the Mamba state and one KV slot a
    shared-block application.  Parameters as :class:`Mamba2`'s, activations in
    ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        if cfg.family != "hybrid":
            raise NotImplementedError(f"model family {cfg.family!r} is not a hybrid model")
        self._check_dense_parts(cfg)
        if cfg.shared_attn_every < 1:
            raise ValueError(f"{cfg.name}: shared_attn_every must be >= 1, got "
                             f"{cfg.shared_attn_every}")
        self._build_stack(cfg, device)
        self.shared = nn.Module()
        self.shared.attn = self._attn_group()
        self.shared.ln1, self.shared.ln2 = self._norm_group(), self._norm_group()
        self.shared.mlp = self._mlp_group()

    @property
    def applications(self) -> int:
        """How many times a forward runs the shared block."""
        return -(-self.cfg.n_layers // self.cfg.shared_attn_every)

    def init_params(self, seed: int) -> None:
        """Initialise from ``seed``: the ssm stack as :class:`Mamba2`, then
        the shared block at the dense block's scales."""
        super().init_params(seed)
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._init_dense_parts(gen, (self.shared.attn,), (self.shared.mlp,))
        self._init_norms(self.shared.ln1, self.shared.ln2)

    def forward(self, tokens: torch.Tensor, return_cache: bool = False,
                return_hidden: bool = False):
        """tokens (B, S) -> logits (B, S, vocab) in the activation dtype;
        with ``return_cache`` -> (logits, None), as :meth:`Mamba2.forward`;
        with ``return_hidden`` the final-normed hidden states."""
        cfg = self.cfg
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        causal = cfg.causal and not cfg.encoder_only

        def layer(x: torch.Tensor, l: int) -> torch.Tensor:
            x = self._mamba_layer(x, l)
            if l % cfg.shared_attn_every:
                return x
            return self._dense_block(x, self._block(self.shared, None), positions, causal)[0]

        layer = _remat(layer, cfg)
        x = self._embed(tokens)
        for l in range(cfg.n_layers):
            x = layer(x, l)
        logits = self._final(x) if return_hidden else self._head(x)
        return (logits, None) if return_cache else logits

    def init_cache(self, batch: int, max_seq: int, dtype: Optional[torch.dtype] = None) -> dict:
        """Zero decode cache on the model's device: {"mamba": the Mamba
        state (:meth:`_mamba_cache`), "attn": {"k", "v": (n_apps, batch,
        max_seq, KV, hd)}}, one KV slot a shared-block application, in
        ``dtype`` (default the activation dtype; the SSD state stays fp32)."""
        cfg, dtype = self.cfg, dtype or self.dtype
        shape = (self.applications, batch, max_seq, cfg.kv_heads, cfg.hd)
        return {"mamba": self._mamba_cache(batch, dtype),
                "attn": {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                         "v": torch.zeros(shape, dtype=dtype, device=self.device)}}

    def decode_step(self, cache: dict, tokens: torch.Tensor, pos):
        """One token per row: tokens (B, 1), pos an int or (B,) -> (logits
        (B, 1, vocab), cache), the cache updated in place: the shared block
        at layer l reads and writes KV slot ``l // shared_attn_every``."""
        every = self.cfg.shared_attn_every
        pos = _positions(pos, tokens.shape[0], tokens.device)
        shared = self._block(self.shared, None)
        kc, vc = cache["attn"]["k"], cache["attn"]["v"]
        x = self._embed(tokens)
        for l in range(self.cfg.n_layers):
            x = self._decode_mamba(x, l, cache["mamba"])
            if l % every == 0:
                x = self._decode_dense_block(x, shared, kc[l // every], vc[l // every], pos)
        return self._head(x), cache

    def reset_slot(self, cache: dict, slot: int) -> None:
        """Zero row ``slot``'s Mamba state (:meth:`_reset_mamba`); the KV
        rows need none (see :meth:`Transformer.reset_slot`)."""
        self._reset_mamba(cache["mamba"], slot)


class MoETransformer(_LM):
    """The moe family (dbrx-132b, llama4-maverick-400b): pre-norm blocks of
    GQA self-attention and a capacity-routed MoE FFN (:mod:`models.moe`).
    ``moe_every == 1``: every block is attention + MoE, stacked over L.
    ``moe_every > 1``: G = L / moe_every groups of ``per = moe_every - 1``
    dense blocks and one MoE block, stacked (G, per) and (G,).  The
    forward's aux is the Switch load-balancing loss summed over the MoE
    layers (``return_aux``), which :func:`lm_loss` adds at 0.01.  Dense
    blocks are the dense family's; fp32 or bf16 parameters, activations in
    ``cfg.dtype``."""

    has_aux = True

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        if cfg.family != "moe":
            raise NotImplementedError(f"model family {cfg.family!r} is not a moe model")
        self._check_dense_parts(cfg)
        if not (0 < cfg.top_k <= cfg.n_experts) or cfg.moe_every < 1 or (
                cfg.n_layers % cfg.moe_every):
            raise ValueError(f"{cfg.name}: top_k {cfg.top_k} of {cfg.n_experts} experts, "
                             f"moe_every {cfg.moe_every} over {cfg.n_layers} layers")
        self.cfg, self._device = cfg, device
        L, d = cfg.n_layers, cfg.d_model
        head = {} if cfg.tie_embeddings else {"lm_head": self._empty(d, cfg.vocab)}
        self.embed = _group(embed=self._empty(cfg.vocab, d), **head)
        self.blocks = nn.Module()
        if cfg.moe_every == 1:
            self._moe_groups(self.blocks, L)
        else:
            G, per = L // cfg.moe_every, cfg.moe_every - 1
            dense = self.blocks.dense = nn.Module()
            dense.attn, dense.mlp = self._attn_group(G, per), self._mlp_group(G, per)
            dense.ln1, dense.ln2 = self._norm_group(G, per), self._norm_group(G, per)
            self.blocks.moe = nn.Module()
            self._moe_groups(self.blocks.moe, G)
        self.final_norm = self._norm_group()

    def _moe_groups(self, blocks: nn.Module, *lead: int) -> None:
        blocks.attn = self._attn_group(*lead)
        blocks.ln1 = self._norm_group(*lead)
        blocks.ln2 = self._norm_group(*lead)
        blocks.moe = _group(**{name: self._empty(*lead, *shape)
                               for name, shape in moe.param_shapes(self.cfg).items()})

    def stack_dims(self, path: str) -> int:
        """Two for the (G, per) stacks of the dense blocks between MoE blocks."""
        return 2 if path.startswith("blocks/dense/") else super().stack_dims(path)

    @property
    def moe_blocks(self) -> nn.Module:
        """The module of the MoE blocks' stacks (``attn``, ``ln1``, ``ln2``,
        ``moe``)."""
        return self.blocks if self.cfg.moe_every == 1 else self.blocks.moe

    def init_params(self, seed: int) -> None:
        """Initialise from ``seed``: the reference's distributions and
        scales, not its draws (see :meth:`Transformer.init_params`)."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self._init_embed(gen)
        attns = [self.moe_blocks.attn]
        norms = [self.moe_blocks.ln1, self.moe_blocks.ln2, self.final_norm]
        if cfg.moe_every > 1:
            dense = self.blocks.dense
            attns.append(dense.attn)
            norms += [dense.ln1, dense.ln2]
            for w in (dense.mlp.w_in, getattr(dense.mlp, "w_gate", None)):
                if w is not None:
                    trunc_normal_(w, cfg.d_model ** -0.5, gen)
            trunc_normal_(dense.mlp.w_out, cfg.d_ff ** -0.5, gen)
        for attn in attns:
            for w in (attn.wq, attn.wk, attn.wv):
                trunc_normal_(w, cfg.d_model ** -0.5, gen)
            trunc_normal_(attn.wo, (cfg.n_heads * cfg.hd) ** -0.5, gen)
        moe.init_moe(_at(self.moe_blocks.moe), cfg, gen)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.split(".")[-1].startswith("bias_"):
                    p.zero_()
        self._init_norms(*norms)

    def _moe_block(self, x, p, positions, causal):
        x, k, v = self._attend(x, p, positions, causal)
        m, aux = moe.apply_moe(p["moe"], apply_norm(x, p["ln2"], self.cfg), self.cfg)
        return x + m, k, v, aux

    def forward(self, tokens: torch.Tensor, return_cache: bool = False,
                return_hidden: bool = False, return_aux: bool = False):
        """tokens (B, S) -> logits (B, S, vocab) in the activation dtype
        (the final-normed hidden states under ``return_hidden``); with
        ``return_cache`` -> (logits, cache) in :meth:`init_cache`'s layout;
        with ``return_aux`` the fp32 aux loss summed over the MoE layers
        comes last.  Under ``cfg.remat`` each layer (``moe_every == 1``) or
        each group of blocks runs checkpointed, the aux among its outputs."""
        cfg = self.cfg
        x = self._embed(tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        causal = cfg.causal and not cfg.encoder_only
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        kvs = []
        if cfg.moe_every == 1:
            def layer(x: torch.Tensor, l: int):
                return self._moe_block(x, self._block(self.blocks, l), positions, causal)

            layer = _remat(layer, cfg)
            for l in range(cfg.n_layers):
                x, k, v, a = layer(x, l)
                aux = aux + a
                if return_cache:
                    kvs.append((k, v))
            cache = ({"k": torch.stack([k for k, _ in kvs]),
                      "v": torch.stack([v for _, v in kvs])} if return_cache else None)
        else:
            per = cfg.moe_every - 1

            def group(x: torch.Tensor, g: int):
                dense = [None] * per
                for j in range(per):
                    x, *dense[j] = self._dense_block(x, self._block(self.blocks.dense, (g, j)),
                                                     positions, causal)
                x, k, v, a = self._moe_block(x, self._block(self.blocks.moe, g), positions,
                                             causal)
                return (x, torch.stack([kd for kd, _ in dense]),
                        torch.stack([vd for _, vd in dense]), k, v, a)

            group = _remat(group, cfg)
            for g in range(cfg.n_layers // cfg.moe_every):
                x, kd, vd, k, v, a = group(x, g)
                aux = aux + a
                if return_cache:
                    kvs.append((kd, vd, k, v))
            cache = ({"dense": {"k": torch.stack([c[0] for c in kvs]),
                                "v": torch.stack([c[1] for c in kvs])},
                      "moe": {"k": torch.stack([c[2] for c in kvs]),
                              "v": torch.stack([c[3] for c in kvs])}}
                     if return_cache else None)
        out = (self._final(x) if return_hidden else self._head(x),)
        if return_cache:
            out += (cache,)
        if return_aux:
            out += (aux,)
        return out if len(out) > 1 else out[0]

    def init_cache(self, batch: int, max_seq: int,
                   dtype: Optional[torch.dtype] = None) -> dict:
        """Zero KV cache on the model's device, in ``dtype`` (default the
        activation dtype): {"k", "v": (L, batch, max_seq, KV, hd)} for
        ``moe_every == 1``, else the reference's grouped layout {"dense":
        {"k", "v": (G, per, batch, max_seq, KV, hd)}, "moe": {"k", "v": (G,
        batch, max_seq, KV, hd)}}."""
        cfg = self.cfg
        dtype = dtype or self.dtype

        def kv(*lead):
            shape = lead + (batch, max_seq, cfg.kv_heads, cfg.hd)
            return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                    "v": torch.zeros(shape, dtype=dtype, device=self.device)}

        if cfg.moe_every == 1:
            return kv(cfg.n_layers)
        G = cfg.n_layers // cfg.moe_every
        return {"dense": kv(G, cfg.moe_every - 1), "moe": kv(G)}

    def decode_step(self, cache: dict, tokens: torch.Tensor, pos, *,
                    rows_apart: bool = False):
        """One token per row: tokens (B, 1), pos an int or (B,) -> (logits
        (B, 1, vocab), cache), the cache updated in place.  The B tokens
        route as one batch under ``cfg.moe_groups``, as the reference's
        ``decode_step`` routes them, so capacity couples the rows; with
        ``rows_apart`` each row routes alone (one dispatch group a row), as
        in the reference's engine, which decodes each slot at batch 1."""
        cfg = self.cfg
        pos = _positions(pos, tokens.shape[0], tokens.device)
        groups = tokens.shape[0] if rows_apart else None
        x = self._embed(tokens)

        def attend(x, p, kc, vc):
            return x + decode_self_attention(apply_norm(x, p["ln1"], cfg), p["attn"], cfg,
                                             kc, vc, pos)

        def moe_block(x, p, kc, vc):
            x = attend(x, p, kc, vc)
            return x + moe.apply_moe(p["moe"], apply_norm(x, p["ln2"], cfg), cfg,
                                     groups=groups)[0]

        if cfg.moe_every == 1:
            for l in range(cfg.n_layers):
                x = moe_block(x, self._block(self.blocks, l), cache["k"][l], cache["v"][l])
        else:
            dense, moe_cache = cache["dense"], cache["moe"]
            for g in range(cfg.n_layers // cfg.moe_every):
                for j in range(cfg.moe_every - 1):
                    p = self._block(self.blocks.dense, (g, j))
                    x = attend(x, p, dense["k"][g, j], dense["v"][g, j])
                    x = x + apply_mlp(apply_norm(x, p["ln2"], cfg), p["mlp"], cfg.act)
                x = moe_block(x, self._block(self.blocks.moe, g), moe_cache["k"][g],
                              moe_cache["v"][g])
        return self._head(x), cache

    def reset_slot(self, cache: dict, slot: int) -> None:
        """Nothing to reset (see :meth:`Transformer.reset_slot`)."""


class VisionLM(_LM):
    """The vlm family (llama-3.2-vision-11b): G = L / cross_attn_every
    groups, each ``per = cross_attn_every`` dense blocks (stacked (G, per))
    and one gated cross-attention block (stacked (G,)): x attends, unmasked
    and without RoPE, over K/V projected from the images (the stub patch
    embeddings, (B, n_image_tokens, d)), and tanh(gate_attn),
    tanh(gate_mlp) scale the two residual branches (both gates are zero at
    init, so each cross block starts as the identity).  The prefill cache
    holds the self-attention KV and each group's image K/V; decode runs the
    cross blocks on that cached K/V.  fp32 or bf16 parameters, activations
    in ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        if cfg.family != "vlm":
            raise NotImplementedError(f"model family {cfg.family!r} is not a vlm model")
        self._check_dense_parts(cfg)
        every = cfg.cross_attn_every
        if every < 1 or cfg.n_layers % every or cfg.n_image_tokens < 1:
            raise ValueError(f"{cfg.name}: cross_attn_every {every} over {cfg.n_layers} "
                             f"layers, {cfg.n_image_tokens} image tokens")
        self.cfg, self._device = cfg, device
        G, d = cfg.n_layers // every, cfg.d_model
        head = {} if cfg.tie_embeddings else {"lm_head": self._empty(d, cfg.vocab)}
        self.embed = _group(embed=self._empty(cfg.vocab, d), **head)
        self.blocks = nn.Module()
        own = nn.Module()  # blocks/self
        own.attn, own.mlp = self._attn_group(G, every), self._mlp_group(G, every)
        own.ln1, own.ln2 = self._norm_group(G, every), self._norm_group(G, every)
        self.blocks.add_module("self", own)
        cross = self.blocks.cross = nn.Module()
        cross.xattn, cross.mlp = self._attn_group(G), self._mlp_group(G)
        cross.ln, cross.ln_mlp = self._norm_group(G), self._norm_group(G)
        cross.register_parameter("gate_attn", nn.Parameter(self._empty(G)))
        cross.register_parameter("gate_mlp", nn.Parameter(self._empty(G)))
        self.final_norm = self._norm_group()

    @property
    def groups(self) -> int:
        return self.cfg.n_layers // self.cfg.cross_attn_every

    def stack_dims(self, path: str) -> int:
        """Two for the (G, per) stacks of the self-attention blocks."""
        return 2 if path.startswith("blocks/self/") else super().stack_dims(path)

    def init_params(self, seed: int) -> None:
        """Initialise from ``seed``: the reference's distributions and
        scales, not its draws (see :meth:`Transformer.init_params`); the
        gates zero, as the reference's."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        own, cross = self.blocks.get_submodule("self"), self.blocks.cross
        self._init_embed(gen)
        self._init_dense_parts(gen, (own.attn, cross.xattn), (own.mlp, cross.mlp))
        with torch.no_grad():
            cross.gate_attn.zero_()
            cross.gate_mlp.zero_()
        self._init_norms(own.ln1, own.ln2, cross.ln, cross.ln_mlp, self.final_norm)

    def _cross(self, g: int) -> dict:
        """Group ``g``'s cross block: its groups' tensors and the two gates."""
        cross = self.blocks.cross
        return _at_groups(dict(cross.named_children()), g) | {
            "gate_attn": cross.gate_attn[g], "gate_mlp": cross.gate_mlp[g]}

    def _cross_block(self, x, p, xk, xv):
        cfg = self.cfg
        h = cross_attention(apply_norm(x, p["ln"], cfg), p["xattn"], cfg, xk, xv)
        x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * h
        m = apply_mlp(apply_norm(x, p["ln_mlp"], cfg), p["mlp"], cfg.act)
        return x + torch.tanh(p["gate_mlp"]).to(x.dtype) * m

    def forward(self, tokens: torch.Tensor, return_cache: bool = False,
                return_hidden: bool = False, *, images: Optional[torch.Tensor] = None):
        """tokens (B, S) and ``images`` (B, n_image_tokens, d) -> logits (B,
        S, vocab) in the activation dtype (the final-normed hidden states
        under ``return_hidden``); with ``return_cache`` -> (logits,
        :meth:`init_cache`'s layout filled: the self KV (G, per, B, S, KV,
        hd) and each group's image K/V "xk", "xv" (G, B, n_image_tokens, KV,
        hd)).  Under ``cfg.remat`` each group runs checkpointed."""
        if images is None:
            raise ValueError(f"{self.cfg.name} takes images (B, n_image_tokens, d_model) "
                             "beside the tokens")
        cfg = self.cfg
        x = self._embed(tokens)
        img = images.to(x.dtype)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        causal = cfg.causal and not cfg.encoder_only
        own = self.blocks.get_submodule("self")

        def group(x: torch.Tensor, g: int):
            kv = []
            for j in range(cfg.cross_attn_every):
                x, k, v = self._dense_block(x, self._block(own, (g, j)), positions, causal)
                kv.append((k, v))
            p = self._cross(g)
            xk, xv = encode_cross_kv(p["xattn"], img, cfg)
            x = self._cross_block(x, p, xk, xv)
            return (x, torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv]),
                    xk, xv)

        group = _remat(group, cfg)
        caches = []
        for g in range(self.groups):
            x, *kv = group(x, g)
            if return_cache:
                caches.append(kv)
        logits = self._final(x) if return_hidden else self._head(x)
        if not return_cache:
            return logits
        ks, vs, xks, xvs = (torch.stack(parts) for parts in zip(*caches))
        return logits, {"self": {"k": ks, "v": vs}, "xk": xks, "xv": xvs}

    def init_cache(self, batch: int, max_seq: int,
                   dtype: Optional[torch.dtype] = None) -> dict:
        """Zero decode cache on the model's device, in ``dtype`` (default
        the activation dtype): {"self": {"k", "v": (G, per, batch, max_seq,
        KV, hd)}, "xk", "xv": (G, batch, n_image_tokens, KV, hd)}.  The image
        K/V stay zero until a prefill's are copied in (the engine never
        does, as the reference's: its vlm decode is text-only)."""
        cfg, dtype = self.cfg, dtype or self.dtype

        def zeros(*lead):
            return torch.zeros(lead + (cfg.kv_heads, cfg.hd), dtype=dtype, device=self.device)

        G = self.groups
        return {"self": {"k": zeros(G, cfg.cross_attn_every, batch, max_seq),
                         "v": zeros(G, cfg.cross_attn_every, batch, max_seq)},
                "xk": zeros(G, batch, cfg.n_image_tokens),
                "xv": zeros(G, batch, cfg.n_image_tokens)}

    def decode_step(self, cache: dict, tokens: torch.Tensor, pos):
        """One token per row: tokens (B, 1), pos an int or (B,) -> (logits
        (B, 1, vocab), cache), the self KV updated in place; each cross block
        attends over the cached image K/V (``ops.attention`` at S = 1)."""
        pos = _positions(pos, tokens.shape[0], tokens.device)
        own, kc, vc = self.blocks.get_submodule("self"), cache["self"]["k"], cache["self"]["v"]
        x = self._embed(tokens)
        for g in range(self.groups):
            for j in range(self.cfg.cross_attn_every):
                x = self._decode_dense_block(x, self._block(own, (g, j)), kc[g, j], vc[g, j],
                                             pos)
            x = self._cross_block(x, self._cross(g), cache["xk"][g], cache["xv"][g])
        return self._head(x), cache

    def reset_slot(self, cache: dict, slot: int) -> None:
        """Nothing to reset (see :meth:`Transformer.reset_slot`)."""


def lm_loss(logits: torch.Tensor, targets: torch.Tensor, aux: Optional[torch.Tensor] = None,
            *, shift: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy, plus 0.01·aux (the MoE load-balancing
    loss) when there is one.  On a model axis ``logits`` are this rank's
    vocab columns (:func:`repro_torch.models.tensor_parallel.
    vocab_cross_entropy`)."""
    if shift:
        logits, targets = logits[:, :-1], targets[:, 1:]
    tp = tensor_parallel.active()
    if tp is not None:
        ce = torch.mean(tensor_parallel.vocab_cross_entropy(tp, logits, targets))
        return ce if aux is None else ce + 0.01 * aux
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    ce = torch.mean(lse - gold)
    return ce if aux is None else ce + 0.01 * aux


class _ChunkCrossEntropy(torch.autograd.Function):
    """``sum((logsumexp(h w) - (h w)[target]) * mask)`` over one chunk of
    rows.  The chunk's ``(B, chunk, V)`` logits live only inside forward and
    backward, one buffer each: forward takes the logsumexp in place, and
    backward recomputes the logits and turns them into the softmax's
    gradient in place.  With ``split`` (a model axis) ``w`` holds this
    rank's vocab columns: the log-sum-exp and the target logit come from
    :func:`repro_torch.models.tensor_parallel.lse_and_gold`."""

    @staticmethod
    def forward(ctx, h, w, targets, mask, split=None):
        logits = (h @ w.to(h.dtype)).to(torch.float32)
        ctx.split = split
        if split is not None:
            lse, gold, at, inside = tensor_parallel.lse_and_gold(split, logits, targets)
            ctx.save_for_backward(h, w, at, mask, lse, inside)
            return torch.sum((lse - gold) * mask)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        top = logits.amax(dim=-1)
        lse = logits.sub_(top[..., None]).exp_().sum(dim=-1).log_().add_(top)
        ctx.save_for_backward(h, w, targets, mask, lse)
        return torch.sum((lse - gold) * mask)

    @staticmethod
    def backward(ctx, grad):
        h, w, targets, mask, lse, *inside = ctx.saved_tensors
        wh = w.to(h.dtype)
        d = (h @ wh).to(torch.float32)
        if inside:  # targets are this rank's columns, inside[0] their mask
            tensor_parallel.softmax_grad_(targets, inside[0], d, lse)
        else:
            d.sub_(lse[..., None]).exp_()                       # softmax
            d.scatter_add_(-1, targets[..., None],
                           torch.full(targets.shape + (1,), -1.0, device=d.device))
        d.mul_((grad * mask)[..., None])                    # d loss / d logits
        d = d.to(h.dtype)
        dh = d @ wh.mT
        dw = h.reshape(-1, h.shape[-1]).mT @ d.reshape(-1, d.shape[-1])
        return dh, dw.to(w.dtype), None, None, None


def chunked_lm_loss(hidden: torch.Tensor, targets: torch.Tensor, chunk: int,
                    embed: torch.Tensor, lm_head: Optional[torch.Tensor] = None, *,
                    shift: bool = True, aux: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy with the logits made ``chunk`` positions
    at a time, never as the full ``(B, S, V)`` tensor (the reference's
    ``chunked_lm_loss``, ``cfg.logit_chunk``): ``hidden`` is the
    final-normed ``(B, S, d)`` (``forward(return_hidden=True)``), the head
    the tied ``embed`` (vocab, d) or the untied ``lm_head`` (d, vocab).  The
    last chunk is zero-padded and masked out; backward recomputes each
    chunk's logits.  ``aux`` (the MoE load-balancing loss) adds at 0.01, as
    in :func:`lm_loss`.  On a model axis the head is this rank's vocab
    columns, each chunk's three reductions run over the axis, and
    ``hidden``'s gradient is summed over it once."""
    tp = tensor_parallel.active()
    if tp is not None:
        hidden = tensor_parallel.enter(tp, hidden)
    if shift:
        hidden, targets = hidden[:, :-1], targets[:, 1:]
    B, S, _ = hidden.shape
    pad = (-S) % chunk
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
    targets = targets.long()
    valid = (torch.arange(S + pad, device=hidden.device) < S).to(torch.float32)
    valid = valid.expand(B, S + pad)
    w = embed.T if lm_head is None else lm_head
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S + pad, chunk):
        part = slice(c0, c0 + chunk)
        total = total + _ChunkCrossEntropy.apply(hidden[:, part], w, targets[:, part],
                                                 valid[:, part], tp)
    ce = total / (B * S)
    return ce if aux is None else ce + 0.01 * aux


FAMILIES = {"dense": Transformer, "audio": Transformer, "ssm": Mamba2, "hybrid": Hybrid,
            "moe": MoETransformer, "vlm": VisionLM}


def build_model(cfg: ModelConfig, *,
                device: Optional[str | torch.device] = None) -> _LM:
    """The model for ``cfg`` (by ``cfg.family``) on ``device`` (default: the
    CUDA device; raises when there is none — pass ``device="cpu"`` for the
    CPU), with its parameters allocated but not initialised (see
    ``init_params``).  An unknown family raises ``ValueError``."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; known: {sorted(FAMILIES)}")
    return FAMILIES[cfg.family](cfg, resolve_device(device))
