"""The train, prefill and serve steps (the port of the JAX package's
``launch/steps.py``: ``make_train_step`` with gradient accumulation and the
projected-space accumulator, ``make_prefill_step`` and
``make_serve_step``).  On a data mesh ``make_train_step`` is the
data-parallel step: each rank's gradient of its rows of the batch is summed
over the ranks in one all-reduce (:func:`reduce_gradients`); under the
projected-space accumulator the ranks' compact accumulators are.  On a
mesh with a ``model`` axis it is also the tensor-parallel step
(:func:`reduce_split_gradients`)."""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.profiler import record_function

from repro_torch.core.api import Transform, clip_by_global_norm, global_norm
from repro_torch.core.combinators import param_parts
from repro_torch.core.lowrank_common import default_lowrank_filter
from repro_torch.models import tensor_parallel
from repro_torch.models.transformer import Transformer, chunked_lm_loss, lm_loss
from repro_torch.sharding import gather_parts


def _model_inputs(model, batch: dict) -> tuple[Optional[torch.Tensor], dict]:
    """The forward's inputs from a batch: the tokens, or under the frames
    front end (audio) ``frames=``; ``images=`` (vlm) where the batch has
    them."""
    kwargs = {"images": batch["images"]} if "images" in batch else {}
    if model.cfg.frontend == "frames":
        return None, kwargs | {"frames": batch["frames"]}
    return batch["tokens"], kwargs


def _loss_from_batch(model: Transformer, batch: dict) -> torch.Tensor:
    """The loss of one batch, as the reference's: next-token cross-entropy
    on the tokens, or under the frames front end (audio) cross-entropy on
    ``batch["targets"]`` position by position (no shift); through
    :func:`chunked_lm_loss` when ``cfg.logit_chunk > 0`` (no ``(B, S, V)``
    logits are held), else :func:`lm_loss` on the full logits; a family
    with an aux loss (moe) adds it."""
    inputs, kwargs = _model_inputs(model, batch)
    frames = "frames" in kwargs
    targets = batch["targets"] if frames else inputs
    chunk = model.cfg.logit_chunk
    aux = None
    if getattr(model, "has_aux", False):
        out, aux = model(inputs, return_hidden=chunk > 0, return_aux=True, **kwargs)
    else:
        out = model(inputs, return_hidden=chunk > 0, **kwargs)
    if chunk > 0:
        return chunked_lm_loss(out, targets, chunk, getattr(model.embed, "embed", None),
                               getattr(model.embed, "lm_head", None), shift=not frames, aux=aux)
    return lm_loss(out, targets, aux, shift=not frames)


def split_microbatches(batch: dict, microbatches: int) -> list[dict]:
    """The batch's rows in ``microbatches`` equal, consecutive slices (of
    every entry: tokens, frames and targets, images)."""
    rows = next(iter(batch.values())).shape[0]
    if rows % microbatches:
        raise ValueError(f"batch of {rows} rows does not split into {microbatches} "
                         "equal microbatches")
    size = rows // microbatches
    return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            for i in range(microbatches)]


def _value_and_grad(model: Transformer, params: dict, batch: dict):
    loss = _loss_from_batch(model, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def loss_and_grads(model: Transformer, params: dict, batch: dict,
                   microbatches: int = 1) -> tuple[torch.Tensor, dict]:
    """The batch's loss and gradients, accumulated over ``microbatches``
    slices of its rows as the reference does: an fp32 accumulator seeded
    from microbatch 0, the others added in order, then the summed loss and
    gradients divided by ``microbatches``."""
    if microbatches == 1:
        return _value_and_grad(model, params, batch)
    first, *rest = split_microbatches(batch, microbatches)
    loss, grads = _value_and_grad(model, params, first)
    grads = {k: g.to(torch.float32) for k, g in grads.items()}
    for mb in rest:
        mb_loss, mb_grads = _value_and_grad(model, params, mb)
        loss = loss + mb_loss
        for k, g in mb_grads.items():
            grads[k].add_(g.to(torch.float32))
    return loss / microbatches, {k: g / microbatches for k, g in grads.items()}


def split_loss_and_grads(model: Transformer, params: dict, batch: dict, split,
                         microbatches: int = 1) -> tuple[torch.Tensor, dict]:
    """:func:`loss_and_grads` on split parameters (a
    :class:`repro_torch.sharding.ParamSplit`): each microbatch's forward and
    backward run under ``split.gathered()``, so the gradients of the leaves
    split over ``data`` are reduce-scattered layer by layer into
    ``split.grads`` (summed over the ranks and the microbatches, in fp32)
    and only the others' come back (a leaf split over ``model`` alone in
    its part's shape), accumulated as :func:`loss_and_grads` does; both
    divided by ``microbatches``."""
    split.begin_step()
    loss, grads = None, None
    for mb in split_microbatches(batch, microbatches):
        with split.gathered():
            mb_loss = _loss_from_batch(model, mb)
            got = torch.autograd.grad(mb_loss, list(params.values()), allow_unused=True)
        mb_grads = {k: g for k, g in zip(params, got) if k not in split.data_rules}
        if loss is None:
            loss, grads = mb_loss.detach(), mb_grads
            if microbatches > 1:
                grads = {k: None if g is None else g.to(torch.float32) for k, g in grads.items()}
            continue
        loss = loss + mb_loss.detach()
        for k, g in mb_grads.items():
            if g is not None:
                grads[k].add_(g.to(torch.float32))
    if microbatches > 1:
        loss = loss / microbatches
        grads = {k: None if g is None else g / microbatches for k, g in grads.items()}
        for part in split.grads.values():
            part.div_(microbatches)
    return loss, grads


def reduce_split_gradients(mesh, loss: torch.Tensor, grads: dict, split) -> tuple[torch.Tensor,
                                                                                     dict]:
    """:func:`reduce_gradients` after :func:`split_loss_and_grads`, over the
    data axis: the other leaves' gradients summed in one fp32 all-reduce
    (tag ``grad``), the reduced fp32 parts of those split over ``data``
    gathered in ONE all-gather (tag ``grad``), the loss summed in a third,
    fp32 one; each divided by the rank count in fp32.  A reduce-scatter then
    an all-gather send the bytes of one all-reduce, and at 2 ranks the same
    sums.  On a model axis (tensor parallelism) the gradients are then made
    whole over it (:func:`tensor_parallel_gradients`)."""
    n = mesh.shape[mesh.data_axis]
    keys = [k for k, g in grads.items() if g is not None]
    reduced = {}
    if keys:
        flat = torch.cat([grads[k].reshape(-1).to(torch.float32) for k in keys])
        mesh.all_reduce(flat, "grad")
        at = 0
        for k in keys:
            z = grads[k].numel()
            reduced[k] = flat[at:at + z].view(grads[k].shape) / n
            at += z
    paths = [k for k in split.shapes if k in split.data_rules]
    if paths:
        wholes = gather_parts(mesh, [split.grads[k] for k in paths],
                              [split.data_rules[k].dim for k in paths], "grad")
        split.grads = {}  # the parts are spent: free them before the update
        reduced.update({k: w.div_(n) for k, w in zip(paths, wholes)})  # fresh buffers
    total = loss.detach().to(torch.float32).reshape(1).clone()
    mesh.all_reduce(total, "loss")
    reduced = {k: reduced.get(k) for k in split.shapes}
    if split.tp > 1:
        reduced = tensor_parallel_gradients(mesh, reduced, split)
    return total[0] / n, reduced


def tensor_parallel_gradients(mesh, grads: dict, split) -> dict:
    """The gradients of a tensor-parallel step made whole over the model
    axis (every rank of a model line alike): the leaves a rank reads in
    slices (:func:`repro_torch.models.tensor_parallel.summed_paths`) summed
    in one fp32 all-reduce (tag ``tp_grad``), then the fp32 parts of every
    leaf split over ``model`` gathered whole in ONE all-gather (tag
    ``tp_grad``).  With them the optimizer runs as on one process and each
    rank applies its part of the update."""
    grads = dict(grads)
    summed = [k for k in split.shapes if k in tensor_parallel.summed_paths(split)
              and grads.get(k) is not None]
    if summed:
        flat = torch.cat([grads[k].reshape(-1).to(torch.float32) for k in summed])
        mesh.all_reduce(flat, "tp_grad", axis="model")
        at = 0
        for k in summed:
            z = grads[k].numel()
            grads[k] = flat[at:at + z].view(grads[k].shape)
            at += z
    paths = [k for k in split.shapes if k in split.model_rules and grads.get(k) is not None]
    if paths:
        wholes = gather_parts(mesh, [grads[k].to(torch.float32) for k in paths],
                              [split.model_rules[k].dim for k in paths], "tp_grad",
                              axis="model")
        grads.update(zip(paths, wholes))
    return grads


def reduce_gradients(mesh, loss: torch.Tensor, grads: dict,
                     reduce_dtype: torch.dtype) -> tuple[torch.Tensor, dict]:
    """The mean over the ranks of ``mesh``'s data axis of each rank's loss and
    gradients: the gradients cast to ``reduce_dtype`` and summed in ONE
    all-reduce of their concatenation (the reference's tree-level psum),
    then in fp32 divided by the rank count; the loss summed in fp32 in a
    second all-reduce and divided the same way."""
    n = mesh.shape[mesh.data_axis]
    keys = [k for k, g in grads.items() if g is not None]
    flat = torch.cat([grads[k].reshape(-1).to(reduce_dtype) for k in keys])
    mesh.all_reduce(flat, "grad")
    total = loss.detach().to(torch.float32).reshape(1).clone()
    mesh.all_reduce(total, "loss")
    out, at = dict(grads), 0
    for k in keys:
        z = grads[k].numel()
        out[k] = flat[at:at + z].view(grads[k].shape).to(torch.float32) / n
        at += z
    return total[0] / n, out


def _apply_in_place(params: dict, updates: dict, lowrank_paths: Optional[set], split=None):
    """``p += u`` for every leaf with an update; with ``lowrank_paths`` also
    the norm of the applied change, (p + u) - p, over all leaves and over
    those paths: one pass over each leaf's change, the two norms from the
    same per-leaf sums.  On split parameters (``split``, a
    :class:`repro_torch.sharding.ParamSplit`) the updates are the rank's
    parts (:func:`repro_torch.core.combinators.param_parts`) and each rank
    adds them to its parts, and the norms' sums over the parts (a whole leaf
    counted on the first rank only) meet in one fp32 all-reduce; on a model
    axis a leaf counts on the ranks at coordinate 0 of each axis that does
    not split it, and the sums meet over the model axis too."""
    total, lowrank = [], []

    def counts(k) -> bool:
        if split is None:
            return True
        mesh = split.mesh
        return all(mesh.coordinate(axis) == 0 for axis, cuts in
                   ((mesh.data_axis, split.data_rules), ("model", split.model_rules))
                   if axis in mesh.shape and k not in cuts)
    for k, p in params.items():
        u = updates[k]
        if u is None:
            continue
        if lowrank_paths is None:
            p.add_(u.to(p.dtype))
            continue
        new = p + u.to(p.dtype)
        with record_function("extra_metrics"):  # the profiler's name for this pass
            sq = torch.sum(torch.square((new - p).to(torch.float32)))
        p.copy_(new)
        if not counts(k):
            continue
        total.append(sq)
        if k in lowrank_paths:
            lowrank.append(sq)
    if lowrank_paths is None:
        return None
    zero = torch.zeros((), device=next(iter(params.values())).device)
    sums = sum(total, zero), sum(lowrank, zero)
    if split is not None:
        both = torch.stack(sums)
        split.mesh.all_reduce(both, "norms")
        if split.tp > 1:
            split.mesh.all_reduce(both, "norms", axis="model")
        sums = both[0], both[1]
    return torch.sqrt(sums[0]), torch.sqrt(sums[1])


def _lowrank_paths(params: dict) -> set:
    """The paths that ``default_lowrank_filter`` routes to the low-rank
    stage (the dead-subspace detector's leaves)."""
    return {k for k, p in params.items() if default_lowrank_filter(k, p)}


def _guarded_update(transform: Transform, params: dict, opt_state, grads: dict,
                    loss: torch.Tensor, grad_clip: float, fault_gate=None,
                    fault: Optional[dict] = None, lowrank_paths: Optional[set] = None,
                    split=None):
    """Corrupt the raw gradients through ``fault_gate`` (when given), clip,
    then apply ``transform``'s update in place unless the loss or the
    (clipped) gradient norm is not finite.  ``lowrank_paths`` (extra
    metrics on) adds ``grad_norm_raw``, ``update_norm`` and
    ``update_norm_lowrank``; the raw norm is the clip's own, so the clipped
    gradients are the bits of :func:`clip_by_global_norm`'s.  On split
    parameters (``split``) the update runs under
    :func:`repro_torch.core.combinators.param_parts` on whole gradients with
    the parameters' whole-shaped stand-ins, and each rank applies its
    parts."""
    if fault_gate is not None and fault is not None:
        grads = fault_gate.apply(grads, fault)
    extra = lowrank_paths is not None
    gnorm_raw = global_norm(grads) if extra else None
    if grad_clip > 0:
        grads = clip_by_global_norm(grads, grad_clip, norm=gnorm_raw)
    gnorm = gnorm_raw if extra and grad_clip <= 0 else global_norm(grads)
    finite = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
    norms = None
    if finite:
        with torch.no_grad():
            if split is None:
                updates, opt_state = transform.update(
                    grads, opt_state, {k: p.detach() for k, p in params.items()})
                norms = _apply_in_place(params, updates, lowrank_paths)
            else:
                with param_parts(split.parts()):
                    updates, opt_state = transform.update(grads, opt_state, split.standins())
                    norms = _apply_in_place(params, updates, lowrank_paths, split)
    metrics = {"loss": loss.detach(), "grad_norm": gnorm, "update_applied": finite}
    if extra:
        # a skipped step changes nothing: both update norms are 0
        zero = torch.zeros((), device=gnorm.device)
        metrics["grad_norm_raw"] = gnorm_raw
        metrics["update_norm"], metrics["update_norm_lowrank"] = norms or (zero, zero)
    return opt_state, metrics


def make_train_step(model: Transformer, optimizer: Transform, *,
                    grad_clip: float = 0.0, microbatches: int = 1,
                    lowrank_accum=None, fault_gate=None,
                    extra_metrics: bool = False, mesh=None,
                    reduce_dtype: torch.dtype = torch.float32,
                    shard_state: bool = False, param_split=None) -> Callable:
    """``(params, opt_state, batch) -> (opt_state, metrics)``.

    ``params`` is ``model.params()``, updated **in place** (``p += u`` under
    ``no_grad``, so no second copy of the weights exists); the optimizer
    itself is functional.  ``microbatches > 1`` accumulates the gradients
    of that many equal slices of the batch's rows (:func:`loss_and_grads`;
    a batch that does not divide raises ``ValueError``).

    ``lowrank_accum`` (a :class:`repro_torch.core.gum.GUMAccumTools`) with
    more than one microbatch in all accumulates in the PROJECTED space
    instead: the low-rank leaves hold ``Pᵀ G`` plus the gamma sampled
    blocks in place of a full-shape fp32 gradient, and
    ``lowrank_accum.transform`` takes the step (``optimizer`` is not used).

    **NaN/Inf guard:** when the loss or the (clipped) gradient norm is not
    finite the step applies no update and returns the old optimizer state
    (``update_applied=False``) — the outcome of the reference's in-jit
    guard, decided on the host from one synchronising read per step.

    ``fault_gate`` (a :class:`repro_torch.resilience.FaultGate`): the step
    takes a fourth argument ``fault = {"mode", "scale"}`` and corrupts the
    raw gradients (after accumulation, before the clip); mode 0, or no
    ``fault``, leaves them as they are.  Not wired into the projected-space
    accumulator (``NotImplementedError``, as in the reference).

    ``extra_metrics=True`` adds the health monitor's signals (not on the
    projected-space accumulator's step, as in the reference):
    ``grad_norm_raw`` (pre-clip, reused as the clip's own norm),
    ``update_norm`` (global norm of the applied parameter change) and
    ``update_norm_lowrank`` (the same norm over the leaves
    ``default_lowrank_filter`` routes to the low-rank stage: the
    dead-subspace detector's signal).

    ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`) makes it the
    data-parallel step of one rank: ``batch`` is this rank's rows, and the
    loss and gradients are averaged over the ranks of its data axis by
    :func:`reduce_gradients` in ``reduce_dtype`` before the fault gate, the
    clip and the update, so every rank takes the same update (parameters
    stay replicated).  Each rank's gradients are cast once to
    ``reduce_dtype`` and summed in one all-reduce: the ``Trainer`` passes
    fp32, so on bf16-stored parameters each rank's bf16 gradient is cast to
    fp32 and the casts are summed, the arithmetic of the one-process run at
    ``microbatches=n``; ``launch.shardmap_fsdp`` passes bf16 (one rounding
    of the n-term sum, as the reference's ``psum``).  ``shard_state`` runs
    the update under :func:`repro_torch.core.combinators.family_sharding`:
    ``opt_state`` is then in the layout of ``shard_family_state``.

    ``mesh`` with ``lowrank_accum``: the step of rank ``k`` of ``n`` is the
    one-process accumulator at ``n·microbatches`` microbatches over the
    global batch; the rank's local microbatch ``j`` is global microbatch
    ``k·microbatches + j`` (its rows are ``[k·B/n, (k+1)·B/n)``).  On a
    period boundary the projectors refresh from global microbatch 0, rank
    0's first: its raw low-rank gradients reach every rank in one
    broadcast (tag ``refresh``), and every rank refreshes on them with the
    same keys.  Each rank projects its microbatches and sums the compact
    leaves in order; the ranks' sums meet in ONE all-reduce at
    ``reduce_dtype`` (tag ``grad``, fp32 by default: ``r·n`` plus the
    sampled blocks a low-rank leaf, in place of ``m·n``), the loss in a
    second, fp32 one (:func:`reduce_gradients`); the sums are divided by
    ``n``, then by ``microbatches``, reconstructed and applied by the
    guarded update.  With ``shard_state`` it raises
    ``NotImplementedError`` (ROADMAP queue 1 item 5i).

    ``param_split`` (a :class:`repro_torch.sharding.ParamSplit` of
    ``model`` over ``mesh``, whose parameters it has split) is the step on
    split parameters (ZeRO-3): the forward gathers each layer's parameter
    parts in one all-gather, the backward reduce-scatters each layer's
    gradient in one fp32 collective (:func:`split_loss_and_grads`), one
    all-gather makes the reduced parts whole gradients
    (:func:`reduce_split_gradients`), the optimizer runs on them as it does
    on a replicated mesh, and each rank applies its part of the update
    (:func:`repro_torch.core.combinators.param_parts`).  At 2 ranks it is
    bitwise the replicated mesh step (the same fp32 sums); the
    projected-space accumulator under it raises ``NotImplementedError``
    (ROADMAP queue 1 item 5j).

    On a mesh with a ``model`` axis larger than 1 ``param_split`` is
    required (the ``Trainer`` makes it, with or without the data side):
    the layers compute on the model-side parts (tensor parallelism,
    :mod:`repro_torch.models.tensor_parallel`), the gradients are reduced
    over ``data`` as above, then made whole over ``model``
    (:func:`tensor_parallel_gradients`), and each rank applies its part.
    The projected-space accumulator there raises (item 5j)."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    if shard_state and mesh is None:
        raise ValueError("shard_state needs a mesh")
    if param_split is not None and mesh is None:
        raise ValueError("param_split needs a mesh")
    if mesh is not None and mesh.shape.get("model", 1) > 1 and param_split is None:
        raise ValueError("a model axis larger than 1 needs param_split: the ParamSplit that "
                         "holds the parameters' model-side parts")
    ranks = 1 if mesh is None else int(mesh.shape[mesh.data_axis])
    if lowrank_accum is not None and getattr(param_split, "tp", 1) > 1:
        raise NotImplementedError(ACCUM_MODEL_AXIS_REFUSAL)
    if lowrank_accum is not None and microbatches * ranks > 1:
        if param_split is not None:
            raise NotImplementedError(ACCUM_PARAM_SPLIT_REFUSAL)
        if shard_state:
            from repro_torch.core.combinators import ACCUM_SHARDING_REFUSAL

            raise NotImplementedError(ACCUM_SHARDING_REFUSAL)
        if fault_gate is not None:
            raise NotImplementedError("fault injection is not wired into the projected-space "
                                      "accumulation step")
        return _make_lowrank_accum_step(model, lowrank_accum, grad_clip, microbatches, mesh,
                                        reduce_dtype)
    lowrank_paths = _lowrank_paths(model.params()) if extra_metrics else None

    def sharding():
        if not shard_state:
            return contextlib.nullcontext()
        from repro_torch.core.combinators import family_sharding

        return family_sharding(mesh)

    def train_step(params: dict, opt_state, batch: dict, fault: Optional[dict] = None):
        if param_split is not None:
            loss, grads = split_loss_and_grads(model, params, batch, param_split,
                                               microbatches)
            loss, grads = reduce_split_gradients(mesh, loss, grads, param_split)
        else:
            loss, grads = loss_and_grads(model, params, batch, microbatches)
            if mesh is not None:
                loss, grads = reduce_gradients(mesh, loss, grads, reduce_dtype)
        with sharding():
            return _guarded_update(optimizer, params, opt_state, grads, loss, grad_clip,
                                   fault_gate, fault, lowrank_paths, param_split)

    return train_step


# The projected-space accumulator projects every microbatch's gradient, and
# split parameters give a rank only its parts of it.
ACCUM_PARAM_SPLIT_REFUSAL = (
    "the projected-space accumulator (make_train_step(lowrank_accum=)) on split parameters "
    "(shard_params) is not ported (ROADMAP queue 1 item 5j): it projects every "
    "microbatch's whole gradient, and a rank holds only its reduce-scattered parts of it")


ACCUM_MODEL_AXIS_REFUSAL = (
    "the projected-space accumulator (make_train_step(lowrank_accum=)) on a model axis "
    "(tensor parallelism) is not ported (ROADMAP queue 1 item 5j): it projects every "
    "microbatch's whole gradient, and a rank computes only its model-side parts of it")


def _broadcast_from_first(mesh, grads: dict) -> dict:
    """Rank 0's gradients (the leaves that are not None) on every rank, in
    ONE broadcast of their concatenation (tag ``refresh``) at their common
    dtype (a cast both ways is exact)."""
    keys = [k for k, g in grads.items() if g is not None]
    dtype = grads[keys[0]].dtype
    for k in keys[1:]:
        dtype = torch.promote_types(dtype, grads[k].dtype)
    flat = torch.cat([grads[k].reshape(-1).to(dtype) for k in keys])
    mesh.broadcast(flat, "refresh")
    out, at = dict(grads), 0
    for k in keys:
        z = grads[k].numel()
        out[k] = flat[at:at + z].view(grads[k].shape).to(grads[k].dtype)
        at += z
    return out


def _make_lowrank_accum_step(model: Transformer, tools, grad_clip: float,
                             microbatches: int, mesh=None,
                             reduce_dtype: torch.dtype = torch.float32) -> Callable:
    """Microbatch 0's raw gradients refresh the projectors (on a period
    boundary), every microbatch is projected and summed, and the mean is
    reconstructed to full shape for the standard update.  On a ``mesh``
    the refresh reads rank 0's microbatch 0 and the compact sums meet in
    one all-reduce (see :func:`make_train_step`)."""

    def add(acc: Optional[dict], part: Optional[dict]) -> Optional[dict]:
        if part is None:
            return acc
        for key, t in part.items():
            acc[key].add_(t)
        return acc

    def train_step(params: dict, opt_state, batch: dict):
        detached = {k: p.detach() for k, p in params.items()}
        first, *rest = split_microbatches(batch, microbatches)
        loss, grads = _value_and_grad(model, params, first)
        with torch.no_grad():
            reads = grads
            if mesh is not None:
                reads = tools.refresh_reads(grads, opt_state, detached)
                if reads is not None:
                    reads = _broadcast_from_first(mesh, reads)
            if reads is not None:
                opt_state = tools.refresh(reads, opt_state, detached)
            del reads
            acc = tools.project(grads, opt_state, detached)
        del grads
        for mb in rest:
            mb_loss, grads = _value_and_grad(model, params, mb)
            loss = loss + mb_loss
            with torch.no_grad():
                part = tools.project(grads, opt_state, detached)
            acc = {k: add(a, part[k]) for k, a in acc.items()}
            del grads, part
        with torch.no_grad():
            if mesh is not None:  # the mean over the ranks of each rank's sum
                flat = {(k, key): t for k, a in acc.items() if a is not None
                        for key, t in a.items()}
                loss, flat = reduce_gradients(mesh, loss, flat, reduce_dtype)
                acc = {k: None if a is None else {key: flat[(k, key)] for key in a}
                       for k, a in acc.items()}
            loss = loss / microbatches
            acc = {k: None if a is None else {key: t / microbatches for key, t in a.items()}
                   for k, a in acc.items()}
            grads = tools.reconstruct(acc, opt_state, detached)
        return _guarded_update(tools.transform, params, opt_state, grads, loss, grad_clip)

    return train_step


def make_prefill_step(model) -> Callable:
    """``batch -> (logits, cache)``: the forward pass of an inference
    prefill on ``batch["tokens"]`` (``"frames"`` for audio, with
    ``"images"`` for vlm), with the populated cache for the dense, moe and
    vlm families and None for the others (the ssm and hybrid prefill builds
    no decode cache, and audio has no decode, as in the reference).  Runs
    without autograd, so the forward-only kernels run."""
    want_cache = model.cfg.family in ("dense", "moe", "vlm")

    @torch.no_grad()
    def prefill_step(batch: dict):
        inputs, kwargs = _model_inputs(model, batch)
        if want_cache:
            return model(inputs, return_cache=True, **kwargs)
        return model(inputs, **kwargs), None

    return prefill_step


def make_serve_step(model, *, rows_apart: bool = False) -> Callable:
    """``(cache, tokens (B, 1), pos) -> (logits, cache)``: one decode step,
    ``pos`` an int or one position per row; the cache is updated in place.
    ``rows_apart`` decodes every row as if alone, as the reference's engine
    does (it vmaps a batch-1 decode over the slots): only the moe family's
    rows interact (through expert capacity), and they then route one row
    a dispatch group."""
    kwargs = {"rows_apart": True} if rows_apart and model.cfg.family == "moe" else {}

    @torch.no_grad()
    def serve_step(cache: dict, tokens: torch.Tensor, pos):
        return model.decode_step(cache, tokens, pos, **kwargs)

    return serve_step
