"""Tensor parallelism over a mesh's ``model`` axis (Megatron-style), written
explicitly where the JAX package leaves it to GSPMD's propagation of its
``PARAM_RULES`` placements and activation annotations.

On a model axis of size T every leaf whose rule names ``model`` stays split
(:class:`repro_torch.sharding.ParamSplit`): ``wq``, ``wk``, ``wv``, ``w_in``
and ``w_gate`` on their output dim (column-parallel), ``wo`` and ``w_out``
on their input dim (row-parallel), ``embed`` (V, d) and an untied
``lm_head`` (d, V) on the vocab.  The layers read the active split
(:func:`active`, set by ``ParamSplit.gathered()``) and compute on their
parts:

* :func:`enter` (Megatron's *f*): the identity forward, an all-reduce over
  ``model`` of the input's gradient backward, at the entry of each
  column-parallel region (the attention's q/k/v, the MLP's input, the head),
  so the norms before it get their whole gradient on every rank;
* :func:`leave` (Megatron's *g*): the row-parallel partial products summed
  over ``model`` in fp32 and cast back to the activation dtype, the
  identity backward;
* :func:`vocab_embed`: the embedding of the rank's vocab rows (other tokens
  masked to zero), summed over ``model``; its backward sums each row's
  gradients in the wider of the two dtypes, as ``_CastGather`` does;
* :func:`vocab_cross_entropy`: the per-row cross-entropy of vocab-split
  logits from three all-reduces over ``model`` (the row max, the sum of
  exponentials, the target logit), with no collective in its backward;
* :func:`gather_model` (with a reduce-scatter of the gradient backward) for
  ``wk`` and ``wv`` where the kv heads do not divide by T (the reference's
  ``kv_tp = None``).

Every collective records its tag (``tp_fwd``, ``tp_bwd``, ``tp_loss``,
``tp_kv``) through :class:`repro_torch.launch.mesh.Mesh`, over the axis
``model``.  The families other than the dense one refuse a model axis
(:func:`check_family`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.sharding import ParamSplit, active_param_split, gather_parts, reduce_scatter_parts

AXIS = "model"

# Leaves that no rule splits over ``model`` but of which a rank reads a
# slice (its heads' or its columns' entries): their gradients are summed
# over ``model`` after the backward.
SLICED = ("bias_q", "bias_k", "bias_v", "bias_in")


def active() -> Optional[ParamSplit]:
    """The running :class:`ParamSplit` when its model axis is larger than 1
    (the layers then compute on their parts), else None."""
    split = active_param_split()
    return split if split is not None and split.tp > 1 else None


def check_family(cfg) -> None:
    """Raise for a model that tensor parallelism does not port."""
    if cfg.family == "moe":
        raise NotImplementedError(f"{cfg.name}: tensor parallelism of the moe family over a "
                                  "model axis (expert parallelism, ROADMAP queue 1 item 5c) "
                                  "is not ported")
    if cfg.family != "dense" or cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: tensor parallelism of the {cfg.family} family "
                                  "over a model axis is not ported (ROADMAP queue 1 item 5m); "
                                  "the dense family trains on it")


def check_heads(cfg, tp: int) -> None:
    """Raise where the q heads do not divide over the model axis: the
    reference then shards the sequence (``seq_shard_attn``,
    ``seq_parallel_norms``), which the port does not."""
    if cfg.n_heads % tp:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.n_heads} q heads on a {tp}-way model axis: sequence-parallel "
            "attention (the reference's seq_shard_attn / seq_parallel_norms) is not ported "
            "(ROADMAP queue 1 item 5n)")


def summed_paths(split: ParamSplit) -> set:
    """The leaves whose gradient is summed over ``model`` after the backward:
    those of :data:`SLICED`, and ``wk`` / ``wv`` where no rule splits them
    (each rank reads the kv heads of its q heads)."""
    out = set()
    for k in split.shapes:
        name = k.rsplit("/", 1)[-1]
        if name in SLICED or (name in ("wk", "wv") and k not in split.model_rules):
            out.add(k)
    return out


def span(tp: ParamSplit, n: int) -> tuple[int, int]:
    """This rank's contiguous ``n / T`` of ``n`` (heads, columns, vocab rows)."""
    per = n // tp.tp
    return tp.tp_index * per, (tp.tp_index + 1) * per


def local(tp: Optional[ParamSplit], t: torch.Tensor, n: int) -> torch.Tensor:
    """``t``'s entries of this rank on its last dim: ``t`` itself off a model
    axis (``tp`` None) or where that dim is already the part (``n``), else
    its slice of ``T · n``."""
    if tp is None or t.shape[-1] == n:
        return t
    a = tp.tp_index * n
    return t[..., a:a + n]


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split, x):
        ctx.split = split
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        t = g.to(torch.float32, copy=True).contiguous()
        ctx.split.mesh.all_reduce(t, "tp_bwd", axis=AXIS)
        return None, t.to(g.dtype)


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split, x):
        t = x.to(torch.float32, copy=True).contiguous()
        split.mesh.all_reduce(t, "tp_fwd", axis=AXIS)
        return t.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return None, g


def enter(tp: ParamSplit, x: torch.Tensor) -> torch.Tensor:
    """Megatron's *f*: ``x`` forward, its gradient summed over ``model``
    (in fp32) backward."""
    return _Enter.apply(tp, x)


def leave(tp: ParamSplit, x: torch.Tensor) -> torch.Tensor:
    """Megatron's *g*: the partial products ``x`` summed over ``model`` in
    fp32, cast back to ``x``'s dtype; the gradient passes backward."""
    return _Leave.apply(tp, x)


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split, dim, part):
        ctx.split, ctx.dim = split, dim
        return gather_parts(split.mesh, [part.detach()], [dim], "tp_kv", axis=AXIS)[0]

    @staticmethod
    def backward(ctx, g):
        part = reduce_scatter_parts(ctx.split.mesh, [g], [ctx.dim], "tp_kv", axis=AXIS)[0]
        return None, None, part.to(g.dtype)


def gather_model(tp: ParamSplit, part: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole of a leaf split over ``model`` on ``dim`` (one all-gather);
    backward, this rank's part of the gradient summed over ``model`` (one
    fp32 reduce-scatter)."""
    return _GatherModel.apply(tp, dim % part.ndim, part)


class _VocabRows(torch.autograd.Function):
    """``table[local].to(dtype)`` where ``inside``, zero elsewhere; backward
    sums each row's gradients in the wider of ``dtype`` and the table's
    dtype and rounds once into the table's (``_CastGather``'s rule)."""

    @staticmethod
    def forward(ctx, table, local_ids, inside, dtype):
        ctx.save_for_backward(local_ids, inside)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        rows = table[local_ids].to(dtype)
        return torch.where(inside[..., None], rows, torch.zeros((), dtype=dtype,
                                                                device=rows.device))

    @staticmethod
    def backward(ctx, g):
        local_ids, inside = ctx.saved_tensors
        wide = torch.promote_types(g.dtype, ctx.table_dtype)
        total = g.new_zeros(ctx.table_shape, dtype=wide)
        total.index_put_((local_ids[inside],), g[inside].to(wide), accumulate=True)
        return total.to(ctx.table_dtype), None, None, None


def _local_ids(tp: ParamSplit, ids: torch.Tensor, rows: int):
    """``ids`` as rows of this rank's ``rows`` vocab entries (0 outside) and
    the mask of those inside."""
    lo = tp.tp_index * rows
    at = ids.long() - lo
    inside = (at >= 0) & (at < rows)
    return torch.where(inside, at, torch.zeros_like(at)), inside


def vocab_embed(tp: ParamSplit, table: torch.Tensor, tokens: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The embedding of ``tokens`` from this rank's vocab rows ``table``
    (V / T, d), in ``dtype``: the rank's rows, the others zero, summed over
    ``model`` (one all-reduce, whose backward is the identity)."""
    at, inside = _local_ids(tp, tokens, table.shape[0])
    return leave(tp, _VocabRows.apply(table, at, inside, dtype))


def lse_and_gold(tp: ParamSplit, logits: torch.Tensor, targets: torch.Tensor):
    """From fp32 vocab-split ``logits`` (..., V / T): the log-sum-exp over
    the whole vocab and the target's logit, each (...), in three fp32
    all-reduces over ``model`` (max, sum of exponentials, target logit);
    and the targets as this rank's columns with their mask."""
    top = logits.amax(dim=-1)
    tp.mesh.all_reduce(top, "tp_loss", axis=AXIS, op="max")
    total = torch.exp(logits - top[..., None]).sum(dim=-1)
    tp.mesh.all_reduce(total, "tp_loss", axis=AXIS)
    at, inside = _local_ids(tp, targets, logits.shape[-1])
    gold = torch.gather(logits, -1, at[..., None])[..., 0] * inside
    tp.mesh.all_reduce(gold, "tp_loss", axis=AXIS)
    return torch.log(total) + top, gold, at, inside


def softmax_grad_(tp_at, inside, d: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """``d`` (fp32 logits of this rank's columns) turned in place into
    ``softmax - onehot(target)``, the gradient of each row's cross-entropy."""
    d.sub_(lse[..., None]).exp_()
    d.scatter_add_(-1, tp_at[..., None], -inside.to(d.dtype)[..., None])
    return d


class _VocabCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split, logits, targets):
        l32 = logits.to(torch.float32)
        lse, gold, at, inside = lse_and_gold(split, l32, targets)
        ctx.save_for_backward(logits, lse, at, inside)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, lse, at, inside = ctx.saved_tensors
        d = softmax_grad_(at, inside, logits.to(torch.float32, copy=True), lse)
        return None, (d * g[..., None]).to(logits.dtype), None


def vocab_cross_entropy(tp: ParamSplit, logits: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """Each row's cross-entropy (fp32, (...)) of this rank's vocab columns
    ``logits`` (..., V / T) against the global ``targets`` (...)."""
    return _VocabCrossEntropy.apply(tp, logits, targets)
