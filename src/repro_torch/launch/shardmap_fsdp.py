"""The data-parallel train step with its gradient reduction in bf16 (the port
of the JAX package's ``launch/shardmap_fsdp.py``).

Each rank of the mesh's data axis computes the gradient of its rows of the
batch; the gradients are cast to ``reduce_dtype`` (bf16: half the bytes of
an fp32 reduction) and summed in ONE all-reduce of their concatenation, then
taken back to fp32 and divided by the rank count before the clip and the
update.  The loss is averaged in a second, fp32 all-reduce.  Parameters are
replicated on every rank.  The numbers differ from a one-process step only
by the bf16 rounding of each rank's gradient and of their sum.  On
bf16-stored parameters (``ModelConfig.param_dtype="bfloat16"``) the
gradients are bf16 already: the all-reduce sums them with one rounding of
the n-term sum, as the reference's ``psum`` of its bf16 gradients does.  (The
``Trainer``'s mesh step reduces in fp32 instead: each rank's bf16 gradient
cast once to fp32, the casts summed, the one-process run at
``microbatches=n``.)

``shard_state=True`` (a ``fuse_families=True`` optimizer) splits the
family-stacked low-rank state over the data axis
(:func:`repro_torch.core.combinators.family_sharding`), which adds one fp32
all-gather a step: the split families' update rows, with Fira's norm rows
beside them, or under ``fused_epilogue`` their projector and projected
update rows in their place.  Every optimizer of the factory runs under it;
the projected-space accumulator (``make_train_step(lowrank_accum=)``) does
not (ROADMAP queue 1 item 5i).

Like the reference's shard_map step it is data parallelism alone: a mesh
whose ``model`` axis is larger than 1 raises (tensor parallelism runs
through ``Trainer(mesh=)`` and ``make_train_step(param_split=)``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.api import Transform
from repro_torch.launch.steps import make_train_step


def make_shardmap_train_step(model, optimizer: Transform, mesh, *, grad_clip: float = 0.0,
                             reduce_dtype: torch.dtype = torch.bfloat16,
                             shard_state: bool = False, shard_params: bool = False) -> Callable:
    """``(params, opt_state, batch) -> (opt_state, metrics)`` on one rank of
    ``mesh`` (its data axis is ``mesh.data_axis``); ``batch`` is the global
    batch, of which the rank takes rows
    ``[k·B/n, (k+1)·B/n)``, and ``params`` (``model.params()``) is updated
    in place, the same on every rank.

    ``shard_state``: ``opt_state`` is in the layout of
    :func:`~repro_torch.core.combinators.shard_family_state`; the returned
    step's ``place_state(opt_state)`` turns ``optimizer.init``'s whole layout
    into it (and leaves it whole without ``shard_state``).

    ``shard_params`` splits ``model``'s parameters over the data axis (a
    :class:`~repro_torch.sharding.ParamSplit`, the step's ``param_split``;
    ``params`` is then this rank's parts) and reduces in fp32 (any other
    ``reduce_dtype`` raises ``ValueError``).  ``init_state(optimizer)`` is
    ``optimizer.init`` of the whole layout (of the whole shapes, under
    ``shard_params`` the elementwise stages' state of a split parameter in
    its part's shape).

    The step carries ``sharded_step_info``: the reduction dtype, the data
    axis, the shard count, the clip, ``shard_state`` and, when set,
    ``shard_params``."""
    from repro_torch.core.combinators import shard_family_state
    from repro_torch.sharding import ParamSplit

    others = {a: s for a, s in mesh.shape.items() if a != mesh.data_axis and s > 1}
    if others:
        raise NotImplementedError(
            f"make_shardmap_train_step is the data-parallel step, as the reference's shard_map "
            f"step: a mesh with {others} beside its data axis trains through Trainer(mesh=) "
            "(tensor parallelism over the model axis)")
    n = int(mesh.shape[mesh.data_axis])
    k = mesh.coordinate(mesh.data_axis)
    split = None
    if shard_params:
        if reduce_dtype != torch.float32:
            raise ValueError("split parameters reduce their gradients in fp32: pass "
                             "reduce_dtype=torch.float32")
        split = ParamSplit(model, mesh)
        split.split_params()
    inner = make_train_step(model, optimizer, grad_clip=grad_clip, mesh=mesh,
                            reduce_dtype=reduce_dtype, shard_state=shard_state,
                            param_split=split)

    def train_step(params: dict, opt_state, batch: dict):
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split over {n} ranks")
        per = rows // n
        return inner(params, opt_state, {key: v[k * per:(k + 1) * per]
                                         for key, v in batch.items()})

    def place_state(opt_state):
        return shard_family_state(opt_state, mesh) if shard_state else opt_state

    def init_state(opt: Transform):
        if split is None:
            return opt.init({key: p.detach() for key, p in model.params().items()})
        return split.init_state(opt, next(iter(model.params().values())).device)

    train_step.place_state = place_state
    train_step.init_state = init_state
    train_step.param_split = split
    train_step.sharded_step_info = {
        "reduce_dtype": reduce_dtype,
        "data_axis": mesh.data_axis,
        "n_shards": n,
        "grad_clip": float(grad_clip),
        "shard_state": bool(shard_state),
    }
    if shard_params:
        train_step.sharded_step_info["shard_params"] = True
    return train_step
